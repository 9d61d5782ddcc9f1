"""Low-rank ReLU-MLP activation predictor, the port of
sparkinfer_tpu/sparse/predictor.py:

    probs = sigmoid(pred_down . relu(pred_up . x + b_up) + b_down)

computed in f32 whatever the weight dtype, as the JAX package does. The
weights come per layer (pred_up ...), as loop-invariant stacks
(pred_up_all (L, E, R) ...) or as Q8_0 stacks (pred_up_qt / pred_down_qt,
FlatQuantTensor, through the quant_matmul_flat kernel). W8A8 predictor
stacks come with the tiering slice.
"""

from __future__ import annotations

import torch

from ..ops.quant_matmul import FlatQuantTensor, QuantTensor, quant_linear


def resolve_predictor(lp: dict, il: int | None = None) -> tuple:
    """(pred_up, pred_up_b, pred_down, pred_down_b) of one layer: the
    per-layer slices when lp has them, else layer `il` (default
    lp["flat_il"]) of the stacks."""
    if "pred_up" in lp:
        return (lp["pred_up"], lp["pred_up_b"], lp["pred_down"], lp["pred_down_b"])
    if il is None:
        il = lp["flat_il"]
    if "pred_up_qt" in lp:
        # Q8_0 stacks: rebind the layer (the pipelined FFN asks for il + 1)
        return (lp["pred_up_qt"].with_il(il), lp["pred_up_b_all"][il],
                lp["pred_down_qt"].with_il(il), lp["pred_down_b_all"][il])
    return (lp["pred_up_all"][il], lp["pred_up_b_all"][il],
            lp["pred_down_all"][il], lp["pred_down_b_all"][il])


def _linear_f32(x: torch.Tensor, w) -> torch.Tensor:
    if isinstance(w, (QuantTensor, FlatQuantTensor)):
        return quant_linear(x, w)  # x.dtype (f32) out, bf16 operands inside
    return x @ w.float()


def predict_from(pu, pub, pd, pdb, x: torch.Tensor) -> torch.Tensor:
    """pu (E, R), pub (R,), pd (R, F), pdb (F,), plain or packed; x (..., E)
    the normed FFN input. Returns activation probabilities (..., F) in f32."""
    xf = x.float()
    h = (_linear_f32(xf, pu) + pub.float()).clamp_min(0.0)
    return torch.sigmoid(_linear_f32(h, pd) + pdb.float())


def predict_activations(lp: dict, x: torch.Tensor) -> torch.Tensor:
    """Predictor of the layer whose params are `lp` (see resolve_predictor)."""
    return predict_from(*resolve_predictor(lp), x)
