"""The model types of the benchmark's configurations, found by name: a
configuration's ``model`` names the module ``models/<model>.py``, whose
class ``Model`` says how the benchmark makes its data and weights from the
seed, builds the port's model on them through the port's own entry
points, feeds the reference the same, and counts the work of a training
step and of the IW estimator. A new model type is a new module here (and
its reference under ``reference/``); no file that exists changes.

The port is imported inside the methods, never at import time, so that
the reference and the tests of the arithmetic run without it.
"""
from __future__ import annotations

import importlib
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from .. import inputs
from ..reference.numerics import Products

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_]{1,64}$")
# the port's ExperimentConfig fields a configuration file sets
PORT_FIELDS = ("ni", "enc_nh", "dec_nh", "nz", "batch_size", "dec_dropout_in",
               "dec_dropout_out", "optim", "lr", "momentum", "clip_grad", "kl_start", "warm_up",
               "burn_max_iters", "burn_window", "nsamples", "iw_nsamples", "iw_batch",
               "length_buckets", "img_size", "enc_layers", "dec_kernel_size", "dec_layers",
               "dec_filters", "compute_dtype", "use_pallas")
TRAIN_STREAM, TEST_STREAM = 11, 12


def model_for(config: dict, tr: dict):
    """``Model(config, tr)`` of the module ``models/<config["model"]>.py``."""
    name = config["model"]
    if not NAME.match(name) or not (HERE / f"{name}.py").exists():
        raise KeyError(f"model {name!r}: no port_bench/models/{name}.py")
    return importlib.import_module(f"{__name__}.{name}").Model(config, tr)


def port_config(config: dict, overrides: dict):
    """The port's ``ExperimentConfig`` of ``config["dataset"]`` with every
    field the file (and the traffic's ``overrides``) sets."""
    from vae_lagging_encoder_tpu_torch.config import get_config

    fields = {k: config[k] for k in PORT_FIELDS if k in config}
    fields.update(overrides)
    for k in ("length_buckets", "img_size", "enc_layers"):
        if k in fields:
            fields[k] = tuple(fields[k])
    return get_config(config["dataset"], **fields)


def scales_for(shapes: Dict[str, tuple], init: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's init scale: the ``init`` entry of its last name part."""
    return {k: float(init[k.rsplit(".", 1)[-1]]) for k in shapes}


def uniform_weights(shapes: Dict[str, tuple], seed: int, dev, init: Dict[str, float]):
    return inputs.uniform_weights(shapes, scales_for(shapes, init), seed, dev)


def check_leaves(vae, shapes: Dict[str, tuple]) -> None:
    got = {k: tuple(p.shape) for k, p in vae.named_parameters()}
    if got != shapes:
        raise RuntimeError(f"the port's parameters {got} are not the configuration's {shapes}")


def load_weights(vae, shapes: Dict[str, tuple], weights: Dict[str, torch.Tensor]):
    """``vae`` (the port's model) with the benchmark's weights copied in."""
    check_leaves(vae, shapes)
    with torch.no_grad():
        for k, p in vae.named_parameters():
            p.copy_(weights[k])
    return vae


def products(config: dict, control: bool = False) -> Products:
    """The reference's products at the precision ``config`` states (one
    step below for the control, ``control``)."""
    return Products(control, recurrent=config["precision"].get("lstm_recurrent", "float32"))


def flat_batches(groups) -> List[tuple]:
    return [b for _, bs in groups for b in bs]


def counts_of(groups) -> List[int]:
    return [len(bs) for _, bs in groups]


def sample(seq: Sequence, n: int, seed: int, stream: int, must: Optional[int] = None):
    """``n`` distinct items of ``seq`` drawn from the seed, ``must`` among them."""
    idx = list(inputs.rng(seed, stream).permutation(len(seq))[:n])
    if must is not None and must not in idx:
        idx[-1] = must
    return sorted(int(i) for i in idx)
