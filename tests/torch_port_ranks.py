"""Rank workers of the port's data- and tensor-parallel tests.

JAX-free on purpose: ``parallel/launch.py`` starts ranks with the ``spawn``
method, and a rank imports the module of the function it runs, never
``tests/conftest.py`` or JAX. The tests compute the JAX package's
references in their own process and hand the ranks numpy arrays: weights
(the JAX package's parameter tree), batches, and the JAX draws of each dp
rank's rows.

``run_cases(device, cases)`` runs ``(name, kwargs)`` cases in order on
every rank, so that one start of the ranks serves several tests; each
case builds its own ``Mesh`` (every rank builds every group in one order).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from vae_lagging_encoder_tpu_torch.config import get_config
from vae_lagging_encoder_tpu_torch.data import BucketedPool, ImagePool
from vae_lagging_encoder_tpu_torch.data.text import TextBatch
from vae_lagging_encoder_tpu_torch.models import (VAE, GaussianLSTMEncoder, LSTMDecoder,
                                                  build_image_vae)
from vae_lagging_encoder_tpu_torch.parallel import (gather_tree, make_dp_train_step,
                                                    make_tp_eval_step, make_tp_mesh,
                                                    make_tp_train_step, shard_batch,
                                                    shard_model, shard_tree, tp_token_logp)
from vae_lagging_encoder_tpu_torch.train.epoch import (GeneratorNoise, IndexedNoise,
                                                       binarize_prep, make_au_fn, make_eval_fn,
                                                       make_image_loss_fn, make_iwnll_fn,
                                                       make_mi_fn, make_train_epoch)
from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params, to_jax_params


def text_vae(widths: Dict, params=None, device="cpu") -> VAE:
    """The port's text VAE at ``widths`` (vocab, ni, nh, nz, dropouts),
    holding the JAX package's ``params`` when given."""
    vae = VAE(GaussianLSTMEncoder(widths["vocab"], widths["ni"], widths["nh"], widths["nz"]),
              LSTMDecoder(widths["vocab"], widths["ni"], widths["nh"], widths["nz"],
                          dropout_in=widths.get("drop", 0.0), dropout_out=widths.get("drop", 0.0)))
    if params is not None:
        vae.load_state_dict(from_jax_params(params))
    return vae.to(device)


def image_vae(cfg_over: Dict, params, device="cpu") -> VAE:
    vae = build_image_vae(get_config("omniglot", **cfg_over), device=device)
    vae.load_state_dict(from_jax_params(params))
    return vae


def array_draw(draws: Dict[str, np.ndarray]):
    """``draw(site, shape)`` over precomputed arrays (the JAX draws)."""
    def draw(site, shape):
        a = draws[site]
        if tuple(a.shape) != tuple(shape):
            raise AssertionError(f"draw {site}: have {a.shape}, asked {shape}")
        return torch.from_numpy(np.array(a))
    return draw


def dense_params(mesh, vae) -> Dict:
    """The JAX parameter tree of ``vae``, ``dec.pred`` gathered dense."""
    state = gather_tree(mesh, {k: v.detach() for k, v in vae.state_dict().items()},
                        vae.dec.vocab_size) if hasattr(vae.dec, "vocab_size") else vae.state_dict()
    return to_jax_params(state)


def _batch(tokens, mask, rw):
    return (torch.from_numpy(tokens).long(), torch.from_numpy(mask), torch.from_numpy(rw))


# ------------------------------------------------------------------ cases
def case_logp(dev, mesh_shape, h, pred, tgt, w):
    """``sum(tp_token_logp * w)`` and its gradients: the value, dh, this
    rank's dpred columns and its tp index."""
    mesh = make_tp_mesh(*mesh_shape, dev)
    V = pred.shape[1]
    per = V // mesh.tp
    ht = torch.from_numpy(h).to(dev).requires_grad_(True)
    pl = torch.from_numpy(pred[:, mesh.tp_index * per:(mesh.tp_index + 1) * per].copy())
    pl = pl.to(dev).requires_grad_(True)
    logp = tp_token_logp(ht, pl, torch.from_numpy(tgt).long().to(dev), V, mesh.tp_group)
    val = (logp * torch.from_numpy(w).to(dev)).sum()
    val.backward()
    return {"val": float(val), "logp": logp.detach().cpu().numpy(),
            "dh": ht.grad.cpu().numpy(), "dpred": pl.grad.cpu().numpy(),
            "tp_index": mesh.tp_index}


def case_step(dev, mesh_shape, widths, params, batch, draws, kl_weight, lr, clip,
              scale_pred=1.0):
    """One joint SGD step: ``make_dp_train_step`` on a dp-only mesh,
    ``make_tp_train_step`` with a tp group; dp rank ``d`` draws
    ``draws[d]``. The whole batch's aux and the dense parameters after."""
    mesh = make_tp_mesh(*mesh_shape, dev)
    vae = text_vae(widths, params)
    if scale_pred != 1.0:
        with torch.no_grad():
            vae.dec.pred.mul_(scale_pred)
    cfg = get_config("synthetic", nsamples=1, clip_grad=clip)
    if mesh.tp > 1:
        shard_model(mesh, vae)
        step = make_tp_train_step(vae, cfg, mesh)
    else:
        step = make_dp_train_step(vae, cfg, mesh)
    local = shard_batch(mesh, *_batch(*batch))
    aux = step(local, array_draw(draws[mesh.dp_index]), kl_weight, lr)
    return {"aux": [float(a) for a in aux], "params": dense_params(mesh, vae)}


def case_tp_eval(dev, mesh_shape, widths, params, batch, draws):
    mesh = make_tp_mesh(*mesh_shape, dev)
    vae = text_vae(widths, params)
    shard_model(mesh, vae)
    local = shard_batch(mesh, *_batch(*batch))
    aux = make_tp_eval_step(vae, mesh)(local, array_draw(draws[mesh.dp_index]), 1.0)
    return [float(a) for a in aux]


def case_roundtrip(dev, mesh_shape, params, opt_state):
    """shard -> gather of a parameter tree and of an optimizer state."""
    mesh = make_tp_mesh(*mesh_shape, dev)
    state = {k: v for k, v in from_jax_params(params).items()}
    vocab = state["dec.pred"].shape[1]
    local = shard_tree(mesh, state)
    opt_local = shard_tree(mesh, opt_state)
    return {"pred_shape": tuple(local["dec.pred"].shape),
            "params": {k: v.numpy() for k, v in gather_tree(mesh, local, vocab).items()},
            "opt": gather_tree(mesh, opt_local, vocab)}


def case_evaluators(dev, mesh_shape, widths, params, batches, seed, nsamples, ns,
                    image_over=None):
    """ELBO, MI, AU and IW-NLL over a pool of ``batches`` under a mesh
    (one process when ``mesh_shape`` is None), each on ``IndexedNoise(seed
    + k)``."""
    mesh = make_tp_mesh(*mesh_shape, dev) if mesh_shape else None
    if image_over is None:
        vae = text_vae(widths, params)
        pool = BucketedPool([TextBatch(*b) for b in batches], "cpu")
        loss_fn, prep = None, (lambda batch, uniform: batch)
    else:
        vae = image_vae(image_over, params)
        pool = ImagePool(batches, image_over["batch_size"], "cpu")
        loss_fn, prep = make_image_loss_fn(vae), binarize_prep
    if mesh is not None and mesh.tp > 1:
        shard_model(mesh, vae)
    with torch.no_grad():
        ev = make_eval_fn(vae, pool, loss_fn=loss_fn, mesh=mesh)(IndexedNoise(seed, "cpu"))
        mi = make_mi_fn(vae, pool, prep=prep, mesh=mesh)(IndexedNoise(seed + 1, "cpu"))
        au, var = make_au_fn(vae, pool, prep=prep, mesh=mesh)(IndexedNoise(seed + 2, "cpu"))
        iw = make_iwnll_fn(vae, pool, nsamples, ns, prep=prep, mesh=mesh)(
            IndexedNoise(seed + 3, "cpu"))
    return {"ev": ev, "mi": mi, "au": au, "var": var.numpy(), "iw": iw}


def case_epoch(dev, mesh_shape, cfg_over, params, data, seed, kind="text", vocab=None,
               kl_weight=0.5, lr=0.3):
    """One aggressive epoch of ``make_train_epoch`` over a batch-sharded
    pool, dp rank ``d`` drawing ``GeneratorNoise(seed, fold=d)``: the dense
    parameters, the sums, the inner iterations and the KL weight."""
    mesh = make_tp_mesh(*mesh_shape, dev) if mesh_shape else None
    if kind == "text":
        cfg = get_config("synthetic", **cfg_over)
        widths = dict(vocab=vocab, ni=cfg.ni, nh=cfg.enc_nh, nz=cfg.nz, drop=cfg.dec_dropout_in)
        vae = text_vae(widths, params)
        pool = BucketedPool([TextBatch(*b) for b in data], "cpu")
        loss_fn = None
    else:
        cfg = get_config("omniglot", **cfg_over)
        vae = image_vae(cfg_over, params)
        pool = ImagePool(data, cfg.batch_size, "cpu")
        loss_fn = make_image_loss_fn(vae, nsamples=cfg.nsamples, train=True)
    if mesh is not None:
        if mesh.tp > 1:
            shard_model(mesh, vae)
        pool.shard(mesh)
    epoch_fn, opt_init = make_train_epoch(vae, pool, cfg, loss_fn=loss_fn, mesh=mesh)
    noise = GeneratorNoise(seed, "cpu", 0 if mesh is None else mesh.dp_index)
    _, klw, sums, inner = epoch_fn(opt_init(), noise, np.float32(kl_weight), lr,
                                   np.arange(pool.num_batches), True)
    params_out = (dense_params(mesh, vae) if mesh is not None
                  else to_jax_params(vae.state_dict()))
    return {"params": params_out, "sums": sums.tolist(), "inner": int(inner),
            "kl_weight": float(klw)}


def fail_on_rank(dev, rank: int, how: str):
    """Rank ``rank`` fails (``how``: an error, a refusal by ``SystemExit``,
    or a hang in a collective the others never join); the rest succeed or,
    for a hang, wait for it."""
    import time

    import torch.distributed as dist

    if dist.get_rank() == rank:
        if how == "error":
            raise ValueError("broken on purpose")
        if how == "exit":
            raise SystemExit(f"refused on rank {rank}")
        time.sleep(600)
    return dist.get_rank()


def jax_modules_loaded(dev):
    """The modules of JAX, of the JAX package and the tests' conftest that
    this rank holds, after importing the port's CLIs and training loop."""
    import sys

    import vae_lagging_encoder_tpu_torch.cli.image  # noqa: F401
    import vae_lagging_encoder_tpu_torch.cli.text  # noqa: F401
    import vae_lagging_encoder_tpu_torch.train.loop  # noqa: F401

    return sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "vae_lagging_encoder_tpu", "conftest") or m.endswith(".conftest"))


CASES = {"logp": case_logp, "step": case_step, "tp_eval": case_tp_eval,
         "roundtrip": case_roundtrip, "evaluators": case_evaluators, "epoch": case_epoch}


def run_cases(dev, cases: Sequence) -> List:
    """Every ``(name, kwargs)`` of ``cases`` in order, on this rank."""
    return [CASES[name](dev, **kw) for name, kw in cases]
