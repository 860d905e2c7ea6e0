"""The text VAE (LSTM encoder and decoder, fused vocabulary CE): the Yahoo
and Yelp configurations."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import flops, inputs
from ..reference import text_vae as ref_text
from . import load_weights, uniform_weights


class Model:
    def __init__(self, config: dict, tr: dict):
        self.c, self.tr = config, tr
        self.B = config["batch_size"]
        self.K = tr.get("nsamples", config["nsamples"])

    # --------------------------------------------------------------- shapes
    def shapes(self) -> Dict[str, tuple]:
        c = self.c
        V, ni, nz, He, Hd = c["vocab_size"], c["ni"], c["nz"], c["enc_nh"], c["dec_nh"]
        return {"enc.emb": (V, ni), "enc.lstm.wx": (ni, 4 * He), "enc.lstm.wh": (He, 4 * He),
                "enc.lstm.b_ih": (4 * He,), "enc.lstm.b_hh": (4 * He,),
                "enc.linear": (He, 2 * nz),
                "dec.emb": (V, ni), "dec.lstm.wx": (ni + nz, 4 * Hd), "dec.lstm.wh": (Hd, 4 * Hd),
                "dec.lstm.b_ih": (4 * Hd,), "dec.lstm.b_hh": (4 * Hd,), "dec.trans": (nz, Hd),
                "dec.pred": (Hd, V)}

    def weights(self, seed: int, dev, init: Dict[str, float]) -> Dict[str, torch.Tensor]:
        return uniform_weights(self.shapes(), seed, dev, init)

    # ----------------------------------------------------------------- data
    def batches(self, split: str, seed: int, stream: int):
        """``[(bucket_length, [(tokens, mask, row_weight)])]`` (numpy) of
        the split's ``<split>_sentences``."""
        return inputs.text_batches(self.c, self.c[f"{split}_sentences"], self.B, seed, stream)

    def port_pool(self, groups, dev):
        from vae_lagging_encoder_tpu_torch.data import BucketedPool
        from vae_lagging_encoder_tpu_torch.data.text import TextBatch

        return BucketedPool([TextBatch(tokens=t.astype(np.int32), mask=m, row_weight=w)
                             for _, bs in groups for t, m, w in bs], dev)

    def build(self, cfg, weights, dev):
        from vae_lagging_encoder_tpu_torch.models import build_text_vae

        vae = build_text_vae(cfg, self.c["vocab_size"], device=dev,
                             generator=torch.Generator().manual_seed(0))
        return load_weights(vae, self.shapes(), weights)

    def loss_fn(self, vae, cfg):
        return None  # the port's default text loss, as its CLI trains

    # ------------------------------------------------------------ reference
    def ref_batch(self, batch, dev):
        return tuple(torch.from_numpy(a).to(dev) for a in batch)

    def ref_loss(self, w, batch, noise, kl_weight, prods):
        return ref_text.train_loss(w, self.c, batch, noise, kl_weight, prods)

    def ref_nll_iw(self, w, batch, draw, cfg, prods) -> torch.Tensor:
        """The reference's IW-NLL per row of ``batch`` (a reference batch),
        its samples' noise from ``draw(site, shape)`` under the port's sites
        (``iw<j>``, one [B, iw_batch, nz] draw per chunk)."""
        tokens, mask, _ = batch
        B = tokens.shape[0]
        eps = [draw(f"iw{j}", (B, cfg.iw_batch, cfg.nz))
               for j in range(cfg.iw_nsamples // cfg.iw_batch)]
        return ref_text.nll_iw(w, tokens, mask, eps, prods)

    # ---------------------------------------------------------------- counts
    @staticmethod
    def lengths(batch) -> List[int]:
        _, m, w = batch
        return [int(x) for x in m.sum(axis=1)[w > 0]]

    @staticmethod
    def shape_of(batch) -> int:
        """The batch's padded length (the check samples the longest)."""
        return batch[0].shape[1]

    def step_flops(self, batch) -> float:
        return flops.text_train_flops(self.c, self.lengths(batch), self.K)

    def iw_flops(self, batch, nsamples: int, ns: int) -> float:
        return flops.text_iwnll_flops(self.c, self.lengths(batch), nsamples, ns)

    def step_launches(self, batch, iw_chunk: int) -> List[Tuple[str, float]]:
        """The port's kernel launches of one training step with their
        bounds: the encoder's and the decoder's residual forward and
        reverse sweep, the grad-mode CE forward and its VJP."""
        t, m, _ = batch
        B, T = t.shape
        He, Hd, V = self.c["enc_nh"], self.c["dec_nh"], self.c["vocab_size"]
        real = int(m.sum())
        out = []
        for c in range(-(-self.K // iw_chunk)):
            k = min(iw_chunk, self.K - c * iw_chunk)
            rows, N = k * B, k * B * (T - 1)
            out += [("lstm_fwd_residuals", flops.lstm_fwd_bound(T - 1, rows, Hd, (T - 1) * rows,
                                                                True)),
                    ("lstm_bwd", flops.lstm_bwd_bound(T - 1, rows, Hd, (T - 1) * rows)),
                    ("ce_fwd_train", flops.ce_fwd_bound(N, Hd, V, True)),
                    ("ce_bwd", flops.ce_bwd_bound(N, Hd, V))]
        out += [("lstm_fwd_residuals", flops.lstm_fwd_bound(T, B, He, real, True)),
                ("lstm_bwd", flops.lstm_bwd_bound(T, B, He, real))]
        return out

    def iw_launches(self, batch, nsamples: int, ns: int, iw_chunk: int):
        """The IW estimator's launches over one batch: per chunk of ``ns``
        samples the encoder's forward, and per ``iw_chunk`` samples the
        decoder's forward and the CE forward."""
        t, m, _ = batch
        B, T = t.shape
        He, Hd, V = self.c["enc_nh"], self.c["dec_nh"], self.c["vocab_size"]
        real = int(m.sum())
        out = []
        for _ in range(nsamples // ns):
            out.append(("lstm_fwd_infer", flops.lstm_fwd_bound(T, B, He, real, False)))
            for _ in range(-(-ns // iw_chunk)):
                rows = iw_chunk * B
                out += [("lstm_fwd_infer", flops.lstm_fwd_bound(T - 1, rows, Hd, (T - 1) * rows,
                                                                False)),
                        ("ce_fwd", flops.ce_fwd_bound(rows * (T - 1), Hd, V, False))]
        return out
