"""Per-device workspaces of the kernels that add their splits through
counters (`quant_matmul`'s decode kernel, `sparse_ffn_block_v6` and the row
kernel of `sparse_ffn_block` and `_v2`-`_v5`): an int32 buffer allocated
zeroed at the first call on a device and kept, whose counters every call
leaves at 0. The allocation cannot happen inside a CUDA-graph capture, so
the first call on a device must come before one."""

from __future__ import annotations

import torch


def zeroed(cache: dict, device: torch.device, words: int, who: str) -> torch.Tensor:
    """cache[device.index], allocated as `words` zeroed int32 at the first
    call; raises inside a capture if it is not there yet. `who` names the
    kernel in the error."""
    ws = cache.get(device.index)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{who}: the first call on a device allocates its workspace "
                               "and must come before CUDA-graph capture")
        ws = torch.zeros((words,), dtype=torch.int32, device=device)
        cache[device.index] = ws
    return ws
