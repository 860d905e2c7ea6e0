"""The checkpoint formats the port reads beside its own: the reference's
``torch.save(vae.state_dict())`` (utils/torch_import.py) and the JAX
package's legacy round-1 pickle (train/checkpoint.py).

- The nine cases of tests/test_torch_import.py against the port's
  ``torch_import``: exact round trips (also through real ``torch.save``
  files in both serialization formats, through ``load_checkpoint`` and
  through the module's ``main``), the same loss from the imported
  parameters, structural key identification under other attribute names,
  zero biases dropped and nonzero ones refused, export, and the refusals
  of image, multi-layer and unrecognized parameters.
- Both packages side by side: on one state_dict the importers give equal
  trees, and on one parameter tree the exporters give equal state_dicts.
- The legacy pickle: the port reads the one the JAX package reads, and
  refuses a hostile one naming both safe readers' refusals.

Every comparison is exact: the conversions are transposes and copies.
"""
from __future__ import annotations

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from vae_lagging_encoder_tpu.models import VAE as JaxVAE
from vae_lagging_encoder_tpu.models import GaussianLSTMEncoder as JaxEncoder
from vae_lagging_encoder_tpu.models import LSTMDecoder as JaxDecoder
from vae_lagging_encoder_tpu.train.checkpoint import load_checkpoint as jax_load
from vae_lagging_encoder_tpu.utils import torch_import as jax_ti
from vae_lagging_encoder_tpu_torch.models import VAE, GaussianLSTMEncoder, LSTMDecoder
from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params
from vae_lagging_encoder_tpu_torch.utils.torch_import import (
    export_torch_state_dict, import_torch_state_dict, main as import_main)

V, NI, ENC_NH, DEC_NH, NZ = 97, 12, 16, 20, 3


def _make_params(seed=0, ni=NI, enc_nh=ENC_NH, dec_nh=DEC_NH, nz=NZ):
    """The JAX package's initial text-VAE tree (numpy)."""
    vae = JaxVAE(JaxEncoder(V, ni, enc_nh, nz),
                 JaxDecoder(V, ni, dec_nh, nz, dropout_in=0.5, dropout_out=0.5))
    return jax.device_get(vae.init(jax.random.PRNGKey(seed)))


def _reference_state_dict(params, enc_names=None, dec_names=None):
    """The state_dict the reference's module tree would save (the inverse
    of the layout conversions)."""
    t = lambda a: torch.from_numpy(np.asarray(a).copy())
    e, d = params["enc"], params["dec"]
    en = enc_names or {"emb": "embed.weight", "linear": "linear.weight"}
    dn = dec_names or {"emb": "embed.weight", "trans": "trans_linear.weight",
                       "pred": "pred_linear.weight"}
    sd = {}
    for side, p, names in (("encoder", e, en), ("decoder", d, dn)):
        sd[f"{side}.{names['emb']}"] = t(p["emb"])
        sd[f"{side}.lstm.weight_ih_l0"] = t(p["lstm"]["wx"].T)
        sd[f"{side}.lstm.weight_hh_l0"] = t(p["lstm"]["wh"].T)
        sd[f"{side}.lstm.bias_ih_l0"] = t(p["lstm"]["b_ih"])
        sd[f"{side}.lstm.bias_hh_l0"] = t(p["lstm"]["b_hh"])
    sd[f"encoder.{en['linear']}"] = t(e["linear"].T)
    sd[f"decoder.{dn['trans']}"] = t(d["trans"].T)
    sd[f"decoder.{dn['pred']}"] = t(d["pred"].T)
    return sd


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_tree_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def _port_vae(params, ni=NI, enc_nh=ENC_NH, dec_nh=DEC_NH, nz=NZ):
    vae = VAE(GaussianLSTMEncoder(V, ni, enc_nh, nz), LSTMDecoder(V, ni, dec_nh, nz))
    vae.load_state_dict(from_jax_params(params))
    return vae


def test_roundtrip_exact_and_same_math():
    params = _make_params()
    got = import_torch_state_dict(_reference_state_dict(params))
    _assert_tree_equal(params, got)
    # the same math through the port's model, not just the same arrays
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, V, size=(4, 9))).long()
    mask = torch.ones(4, 9)
    eps = torch.from_numpy(rng.randn(4, 1, NZ).astype(np.float32))
    with torch.no_grad():
        a = _port_vae(params).loss(tokens, mask, kl_weight=0.9, eps=eps)
        b = _port_vae(got).loss(tokens, mask, kl_weight=0.9, eps=eps)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("legacy_format", [False, True])
def test_torch_save_file_autodetected(tmp_path, legacy_format):
    params = _make_params(seed=1)
    pt = str(tmp_path / "model.pt")
    torch.save(_reference_state_dict(params), pt,
               _use_new_zipfile_serialization=not legacy_format)
    got, extra = load_checkpoint(pt)
    _assert_tree_equal(params, got)
    assert extra["format"] == "torch_state_dict"


def test_cli_converts_to_npz(tmp_path, capsys):
    params = _make_params(seed=2)
    pt, out = str(tmp_path / "ref.pt"), str(tmp_path / "model.ckpt")
    torch.save(_reference_state_dict(params), pt)
    assert import_main([pt, out]) == 0
    assert f"V={V}" in capsys.readouterr().out
    got, extra = load_checkpoint(out)
    _assert_tree_equal(params, got)
    assert extra["imported_from"] == pt
    _assert_tree_equal(params, jax_load(out)[0])  # and the JAX package reads it


def test_name_drift_tolerated():
    params = _make_params(seed=3, ni=10, dec_nh=10)
    sd = _reference_state_dict(
        params,
        enc_names={"emb": "emb.weight", "linear": "mu_logvar.weight"},
        dec_names={"emb": "word_emb.weight", "trans": "z2h.trans.weight",
                   "pred": "output_linear.weight"})
    _assert_tree_equal(params, import_torch_state_dict(sd))


def test_zero_bias_dropped_nonzero_rejected():
    params = _make_params(seed=4)
    sd = _reference_state_dict(params)
    sd["decoder.trans_linear.bias"] = torch.zeros(DEC_NH)
    _assert_tree_equal(params, import_torch_state_dict(sd))
    sd["decoder.trans_linear.bias"] = torch.full((DEC_NH,), 0.5)
    with pytest.raises(ValueError, match="bias-free"):
        import_torch_state_dict(sd)


def test_export_roundtrip_and_cli(tmp_path, capsys):
    params = _make_params(seed=6)
    sd = export_torch_state_dict(params)
    assert set(sd) == set(_reference_state_dict(params))
    _assert_tree_equal(params, import_torch_state_dict(sd))
    ck, pt = str(tmp_path / "model.ckpt"), str(tmp_path / "back.pt")
    save_checkpoint(ck, params, {})
    assert import_main([ck, pt]) == 0
    assert "exported" in capsys.readouterr().out
    got = torch.load(pt, weights_only=True)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    # the full cycle: the import's own .npz exports again (the direction
    # keys on the file's format, not on the extras' format tag)
    ck2, pt2 = str(tmp_path / "model2.ckpt"), str(tmp_path / "back2.pt")
    assert import_main([pt, ck2]) == 0
    assert "imported" in capsys.readouterr().out
    assert import_main([ck2, pt2]) == 0
    assert "exported" in capsys.readouterr().out
    got2 = torch.load(pt2, weights_only=True)
    for k, v in sd.items():
        assert torch.equal(got2[k], v), k


def test_image_and_multilayer_rejected():
    params = _make_params(seed=5)
    sd = _reference_state_dict(params)
    sd["decoder.conv.weight"] = torch.zeros(4, 4, 3, 3)
    with pytest.raises(NotImplementedError, match="OmniGlot"):
        import_torch_state_dict(sd)
    sd = _reference_state_dict(params)
    sd["encoder.lstm.weight_ih_l1"] = sd["encoder.lstm.weight_ih_l0"]
    with pytest.raises(ValueError, match="multi-layer"):
        import_torch_state_dict(sd)
    with pytest.raises(ValueError, match="encoder"):
        import_torch_state_dict({"decoder.x": torch.zeros(2, 2)})


def test_unrecognized_1d_params_rejected():
    params = _make_params(seed=7)
    sd = _reference_state_dict(params)
    sd["encoder.norm.weight"] = torch.ones(ENC_NH)
    with pytest.raises(ValueError, match="unrecognized"):
        import_torch_state_dict(sd)
    sd = _reference_state_dict(params)
    sd["encoder.stray.bias"] = torch.zeros(ENC_NH)  # an all-zero bias is tolerated
    _assert_tree_equal(params, import_torch_state_dict(sd))


def test_export_rejects_image_pytree():
    with pytest.raises(NotImplementedError, match="text-family"):
        export_torch_state_dict({"enc": {"conv": np.zeros((3, 3, 1, 4))}, "dec": {}})


# ------------------------------------------------- both packages side by side
@pytest.mark.parametrize("seed,ni,dec_nh", [(11, NI, DEC_NH), (12, 10, 10)])
def test_importers_and_exporters_agree_with_jax(seed, ni, dec_nh):
    params = _make_params(seed=seed, ni=ni, dec_nh=dec_nh)
    sd = _reference_state_dict(params)
    sd["decoder.trans_linear.bias"] = torch.zeros(dec_nh)
    _assert_tree_equal(jax_ti.import_torch_state_dict(sd), import_torch_state_dict(sd))
    a, b = jax_ti.export_torch_state_dict(params), export_torch_state_dict(params)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_legacy_pickle_loads_in_both_and_hostile_is_refused(tmp_path):
    params = _make_params(seed=8)
    legacy = str(tmp_path / "legacy.ckpt")
    with open(legacy, "wb") as fh:  # the round-1 format: a pickled dict of numpy
        pickle.dump({"params": params, "extra": {"epoch": 1, "lr": 0.5}}, fh, protocol=4)
    got, extra = load_checkpoint(legacy)
    want, extra_j = jax_load(legacy)
    _assert_tree_equal(params, got)
    _assert_tree_equal(want, got)
    assert extra == extra_j == {"epoch": 1, "lr": 0.5}
    _port_vae(got)  # strict: every name and shape

    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    evil = str(tmp_path / "evil.ckpt")
    with open(evil, "wb") as fh:
        pickle.dump({"params": Evil()}, fh)
    with pytest.raises(pickle.UnpicklingError, match="legacy-pickle reader: checkpoint "
                       "requested forbidden global .*torch weights_only reader"):
        load_checkpoint(evil)
