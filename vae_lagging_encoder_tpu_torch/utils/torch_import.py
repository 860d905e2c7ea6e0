"""Import and export the reference's PyTorch checkpoints.

The port's own copy of ``vae_lagging_encoder_tpu/utils/torch_import.py``
(numpy, torch and this package only). The reference persists
``torch.save(vae.state_dict(), save_path)``, a flat ``{key: tensor}``
state_dict of

    VAE(encoder=GaussianLSTMEncoder(...), decoder=LSTMDecoder(...))

``import_torch_state_dict`` converts it into the JAX package's parameter
tree of numpy arrays (``{"enc": {...}, "dec": {...}}``), the layout every
checkpoint of both packages holds, so ``utils/jax_params.py`` stays the one
place where layouts meet this package's modules and ``--load_path
reference_model.pt`` works for evaluation, generation and fine-tuning.

Key identification is structural: the ``encoder.`` / ``decoder.`` prefixes
(the VAE's submodules); LSTM parameters by ``torch.nn.LSTM``'s canonical
suffixes ``weight_ih_l0 / weight_hh_l0 / bias_ih_l0 / bias_hh_l0``; the
remaining 2-D weights (embedding, the encoder's ``Linear(nh, 2nz)``, the
decoder's ``trans_linear`` / ``pred_linear``) by shape, with substring
name hints breaking genuine shape ties only (at degenerate dims such as
ni == dec_nh). Layouts: a torch ``Linear.weight`` ``[out, in]`` becomes
``[in, out]``; ``weight_ih_l0`` ``[4H, in]`` becomes ``wx [in, 4H]``; the
gate order (i, f, g, o) is the same on both sides; both LSTM biases are
kept. The OmniGlot ResNet/PixelCNN checkpoints and multi-layer or
bidirectional LSTMs are refused (a shape-matched import could load weights
into the wrong layers).

    python -m vae_lagging_encoder_tpu_torch.utils.torch_import IN OUT

converts in the direction IN's format implies (``main``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

_LSTM_SUFFIXES = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")


def _to_np(t) -> np.ndarray:
    a = np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)
    return np.ascontiguousarray(a, dtype=np.float32)


def _take_lstm(side: Dict[str, np.ndarray], who: str) -> Dict[str, np.ndarray]:
    """Pop the four canonical single-layer nn.LSTM params from ``side``."""
    found: Dict[str, str] = {}
    for k in list(side):
        for suf in _LSTM_SUFFIXES:
            if k.endswith(suf):
                if suf in found:
                    raise ValueError(
                        f"{who}: two candidate LSTM params for {suf!r}: "
                        f"{found[suf]!r} and {k!r}")
                found[suf] = k
        if "_l1" in k or "_l0_reverse" in k:
            raise ValueError(
                f"{who}: LSTM key {k!r} implies multi-layer/bidirectional — "
                "the reference models are single-layer unidirectional "
                "(SURVEY.md §2); cannot import")
    missing = [s for s in _LSTM_SUFFIXES if s not in found]
    if missing:
        raise ValueError(f"{who}: state_dict is missing LSTM params "
                         f"{missing} (keys: {sorted(side)})")
    return {
        "wx": side.pop(found["weight_ih_l0"]).T,   # [4H, in] -> [in, 4H]
        "wh": side.pop(found["weight_hh_l0"]).T,   # [4H, H]  -> [H, 4H]
        "b_ih": side.pop(found["bias_ih_l0"]),
        "b_hh": side.pop(found["bias_hh_l0"]),
    }


def _pop_role(side: Dict[str, np.ndarray], role: str, pred, hints,
              who: str) -> np.ndarray:
    """Pop the unique 2-D weight matching ``pred(shape)``; ``hints``
    (substring list) break ties between several shape matches."""
    cands = [k for k, v in side.items() if v.ndim == 2 and pred(v.shape)]
    if len(cands) > 1:
        hinted = [k for k in cands if any(h in k.lower() for h in hints)]
        if len(hinted) == 1:
            cands = hinted
    if len(cands) != 1:
        raise ValueError(f"{who}: cannot identify the {role} weight — "
                         f"candidates {cands or sorted(side)}")
    k = cands[0]
    w = side.pop(k)
    # an all-zero companion bias is dropped; a nonzero one has no slot in
    # this model's math (SURVEY.md marks these layers bias=False [MED]) —
    # better loud than a lossy import.
    if k.endswith(".weight"):
        bias_key = k[: -len(".weight")] + ".bias"
        if bias_key in side:
            b = side.pop(bias_key)
            if np.any(b != 0):
                raise ValueError(
                    f"{who}: {bias_key!r} is nonzero but this model's "
                    f"{role} layer is bias-free; refusing a lossy import")
    return w


def import_torch_state_dict(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Reference ``vae.state_dict()`` -> this framework's params pytree."""
    sd = {k: _to_np(v) for k, v in state_dict.items() if hasattr(v, "shape")}
    if any(v.ndim == 4 for v in sd.values()):
        raise NotImplementedError(
            "state_dict contains conv weights — this looks like the OmniGlot "
            "ResNet/PixelCNN model, whose reference layer geometry is only "
            "[MED]-reconstructed (SURVEY.md §2); a shape-matched import "
            "could silently permute layers, so it is not supported")
    enc = {k[len("encoder."):]: v for k, v in sd.items()
           if k.startswith("encoder.")}
    dec = {k[len("decoder."):]: v for k, v in sd.items()
           if k.startswith("decoder.")}
    if not enc or not dec:
        raise ValueError(
            "expected 'encoder.*' and 'decoder.*' key prefixes (the "
            f"reference VAE's submodules); got keys {sorted(sd)[:8]}...")

    enc_lstm = _take_lstm(enc, "encoder")
    ni = enc_lstm["wx"].shape[0]
    enc_nh = enc_lstm["wh"].shape[0]

    # Remaining encoder 2-D weights: embedding [V, ni] and Linear.weight
    # [2nz, enc_nh]. V (vocab incl. 4 specials) always dwarfs 2nz, so when
    # both could match by shape the larger first dim is the embedding.
    two_d = [(k, v) for k, v in enc.items() if v.ndim == 2]
    if len(two_d) != 2:
        raise ValueError(f"encoder: expected exactly 2 non-LSTM 2-D weights "
                         f"(embedding + linear), got {[k for k, _ in two_d]}")
    emb_key = max(two_d, key=lambda kv: kv[1].shape[0])[0]
    enc_emb = enc.pop(emb_key)
    if enc_emb.shape[1] != ni:
        raise ValueError(f"encoder: embedding dim {enc_emb.shape} does not "
                         f"match LSTM input size {ni}")
    enc_linear = _pop_role(
        enc, "Linear(nh, 2nz)",
        lambda s: s[1] == enc_nh and s[0] % 2 == 0, ("lin",), "encoder").T
    nz = enc_linear.shape[1] // 2

    dec_lstm = _take_lstm(dec, "decoder")
    dec_nh = dec_lstm["wh"].shape[0]
    if dec_lstm["wx"].shape[0] != ni + nz:
        raise ValueError(
            f"decoder LSTM input dim {dec_lstm['wx'].shape[0]} != ni+nz "
            f"({ni}+{nz}) — inconsistent state_dict")

    trans = _pop_role(dec, "trans_linear",
                      lambda s: s == (dec_nh, nz), ("trans",), "decoder").T
    V = enc_emb.shape[0]
    # pred [V, dec_nh] vs embedding [V, ni] collide only when ni == dec_nh;
    # then the reference names ("pred"/"out" vs "emb") break the tie.
    pred = _pop_role(dec, "pred_linear",
                     lambda s: s == (V, dec_nh), ("pred", "out"), "decoder").T
    dec_emb = _pop_role(dec, "embedding",
                        lambda s: s == (V, ni), ("emb",), "decoder")

    # Anything left is a parameter this model has no slot for. All-zero
    # biases are the one tolerated leftover (identical math without them);
    # everything else — including 1-D params like a LayerNorm's — would
    # make the import silently lossy, so reject loudly.
    leftovers = [f"{side}.{k}"
                 for side, d_ in (("encoder", enc), ("decoder", dec))
                 for k, v in d_.items()
                 if not (k.endswith(".bias") and not np.any(v))]
    if leftovers:
        raise ValueError(f"unrecognized reference params: {leftovers}")

    return {
        "enc": {"emb": enc_emb, "lstm": enc_lstm, "linear": enc_linear},
        "dec": {"emb": dec_emb, "lstm": dec_lstm, "trans": trans,
                "pred": pred},
    }


def load_torch_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load a reference ``torch.save`` file and convert it.

    Returns ``(params, extra)`` like ``train.checkpoint.load_checkpoint``.
    Uses ``weights_only=True`` so no arbitrary pickled code can execute —
    the file may come from an untrusted source.
    """
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state_dict (torch.save of "
                         f"vae.state_dict()), got {type(obj)}")
    params = import_torch_state_dict(obj)
    return params, {"imported_from": path, "format": "torch_state_dict"}


def export_torch_state_dict(params: Dict[str, Any]) -> Dict[str, Any]:
    """This framework's text-VAE pytree -> a reference-style state_dict.

    The inverse of :func:`import_torch_state_dict`, so a model trained (or
    fine-tuned) here can go back into the PyTorch reference — or be
    inspected with torch tooling. Key names are the reference module
    tree's most likely names ([MED] while the mount is empty:
    ``embed``/``linear``/``trans_linear``/``pred_linear``, SURVEY.md §2);
    the importer accepts them back regardless, because its matching is
    structural (round-trip is tested exact).
    """
    import torch

    if not (isinstance(params, dict)
            and "lstm" in params.get("enc", {})
            and "lstm" in params.get("dec", {})):
        raise NotImplementedError(
            "only text-family checkpoints (LSTM enc/dec) can be exported to "
            "the reference format; this pytree looks like the OmniGlot "
            "ResNet/PixelCNN model, whose reference layer names are "
            "unverifiable (SURVEY.md §2 [MED])")

    def t(a):
        # explicit copy: np.asarray may give a non-writable array
        # view, which torch.from_numpy warns about (and would alias)
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))

    sd: Dict[str, Any] = {}
    for side, p in (("encoder", params["enc"]), ("decoder", params["dec"])):
        sd[f"{side}.embed.weight"] = t(p["emb"])
        sd[f"{side}.lstm.weight_ih_l0"] = t(p["lstm"]["wx"].T)
        sd[f"{side}.lstm.weight_hh_l0"] = t(p["lstm"]["wh"].T)
        sd[f"{side}.lstm.bias_ih_l0"] = t(p["lstm"]["b_ih"])
        sd[f"{side}.lstm.bias_hh_l0"] = t(p["lstm"]["b_hh"])
    sd["encoder.linear.weight"] = t(params["enc"]["linear"].T)
    sd["decoder.trans_linear.weight"] = t(params["dec"]["trans"].T)
    sd["decoder.pred_linear.weight"] = t(params["dec"]["pred"].T)
    return sd


def main(argv: List[str] | None = None) -> int:
    """CLI: ``python -m vae_lagging_encoder_tpu_torch.utils.torch_import IN OUT``.

    Direction is inferred from IN's format:
    - IN is a reference ``torch.save`` file -> OUT is written in this
      framework's npz format (the direct ``--load_path in.pt`` route also
      works; this tool is for keeping a converted copy);
    - IN is one of this framework's checkpoints -> OUT is written as a
      reference-style ``torch.save(state_dict)`` (text models only).
    """
    import argparse

    from ..train.checkpoint import load_checkpoint, save_checkpoint

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("in_ckpt")
    p.add_argument("out_ckpt")
    a = p.parse_args(argv)

    # Direction keys on the INPUT FILE's format, not on checkpoint
    # metadata: an import-produced npz carries format='torch_state_dict'
    # in its extras, and keying on that would make `torch_import
    # model.ckpt back.pt` silently write another npz.
    with open(a.in_ckpt, "rb") as fh:
        head = fh.read(4)
    in_is_torch = False
    if head[:2] == b"PK":
        import zipfile
        with zipfile.ZipFile(a.in_ckpt) as zf:
            in_is_torch = any(n.endswith("data.pkl") for n in zf.namelist())
    else:  # non-zip: ours is a round-1 pickle, torch's is its legacy format
        params, extra = load_checkpoint(a.in_ckpt)
        in_is_torch = extra.get("format") == "torch_state_dict"

    if in_is_torch:
        params, extra = load_torch_checkpoint(a.in_ckpt)
        save_checkpoint(a.out_ckpt, params, extra)
        verb = "imported"
    else:
        import torch
        params, _ = load_checkpoint(a.in_ckpt)
        torch.save(export_torch_state_dict(params), a.out_ckpt)
        verb = "exported"
    V, ni = params["enc"]["emb"].shape
    print(f"{verb} {a.in_ckpt} -> {a.out_ckpt} "
          f"(V={V}, ni={ni}, enc_nh={params['enc']['lstm']['wh'].shape[0]}, "
          f"dec_nh={params['dec']['lstm']['wh'].shape[0]}, "
          f"nz={params['enc']['linear'].shape[1] // 2})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
