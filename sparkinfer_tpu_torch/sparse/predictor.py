"""Low-rank ReLU-MLP activation predictor, the port of
sparkinfer_tpu/sparse/predictor.py for plain (unquantized) weights:

    probs = sigmoid(pred_down . relu(pred_up . x + b_up) + b_down)

computed in f32 whatever the weight dtype, as the JAX package does.
Q8_0/W8A8 predictor stacks come with the quantized slice.
"""

from __future__ import annotations

import torch


def predict_from(pu, pub, pd, pdb, x: torch.Tensor) -> torch.Tensor:
    """pu (E, R), pub (R,), pd (R, F), pdb (F,); x (..., E) the normed FFN
    input. Returns activation probabilities (..., F) in f32."""
    xf = x.float()
    h = (xf @ pu.float() + pub.float()).clamp_min(0.0)
    return torch.sigmoid(h @ pd.float() + pdb.float())


def predict_activations(lp: dict, x: torch.Tensor) -> torch.Tensor:
    """Predictor of the layer whose params `lp` are (pred_up, pred_up_b,
    pred_down, pred_down_b)."""
    return predict_from(lp["pred_up"], lp["pred_up_b"], lp["pred_down"],
                        lp["pred_down_b"], x)
