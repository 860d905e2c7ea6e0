"""The evaluator set of the reference (test, calc_mi, calc_au, calc_iwnll),
re-exported as ``vae_lagging_encoder_tpu/evaluation/__init__.py`` does; the
implementations live in train/epoch.py (they share the pool machinery with
training) and models/encoder.py."""
from ..models.encoder import calc_mi, eval_inference_dist, gaussian_kl
from ..train.epoch import make_au_fn, make_eval_fn, make_iwnll_fn, make_mi_fn

__all__ = [
    "make_eval_fn", "make_mi_fn", "make_au_fn", "make_iwnll_fn",
    "calc_mi", "eval_inference_dist", "gaussian_kl",
]
