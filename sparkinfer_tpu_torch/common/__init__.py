"""common/ — shared CLI plumbing, the port of sparkinfer_tpu/common/.

One declarative argument table (`args.py`) shared by the entry points,
each row carrying its tools scope and environment-variable mirror, and the
Jinja engine the chat templates run on (`jinja.py`, a copy).
"""

from .args import (  # noqa: F401
    OPTIONS,
    Opt,
    build_parser,
    sampler_from_args,
    unported_flags,
)
