"""LSTM decoder p(x|z) for text: training, evaluation and generation.

Counterpart of ``vae_lagging_encoder_tpu/models/dec_lstm.py``
(the reference's LSTMDecoder):

- word embedding with dropout_in (training only);
- z -> Linear(nz, nh, no bias) -> c0, h0 = tanh(c0);
- z concatenated to the word embedding at every timestep (LSTM input
  ni + nz); rows are z-major, row n = k * B + b. The LSTM takes the two
  parts apart (``lstm_run``'s ``x`` and ``x_row``): the embeddings'
  product once per sentence and step, z's once per row;
- dropout_out on the LSTM outputs (training only), Linear(nh, V, no bias)
  logits; ``reconstruct_error`` is the token-summed masked cross-entropy
  per (sentence, z-sample).

Dropout is ``x / keep`` where ``u < keep`` (keep = 1 - rate) and zero
elsewhere, ``u`` uniform in [0, 1): the JAX package's
``bernoulli(key, keep, shape)`` is ``uniform(key, shape) < keep``, so a test
that hands in the JAX package's uniforms gets its exact keep-masks. The
uniforms come from the caller's ``draw(site, shape)`` (sites ``"keep_in"``
[B, T, ni] and ``"keep_out"`` [K*B, T, nh]); a ``draw`` marks training mode.

The z-sample axis is processed in chunks of ``iw_chunk`` samples (20 on
the kernel route with a fusable vocab, 10 otherwise, as in the JAX
package), which bounds the rows of each LSTM and CE call. Above one chunk
K is padded to whole chunks with zero z (the padding is sliced off), and
with a gradient each chunk's forward runs under ``torch.utils.checkpoint``
(recomputed in the backward, as the JAX package's ``jax.checkpoint``). In
training every chunk ``c`` draws its own dropout, at sites ``"keep_in<c>"``
[B, T, ni] and ``"keep_out<c>"`` [iw_chunk*B, T, nh] in chunk order (the
JAX package's ``split(key, n_chunks)[c]``, split into the two dropout
keys); the masks are drawn before the checkpointed function and passed in,
so the recompute sees the same ones. Where no chunk draws an input dropout
and no gradient is taken (evaluation), the chunks of one call share the
embeddings' product (``_shared_input``): it is computed in the first
chunk's LSTM call.

On the kernel route the vocab projection + CE is the fused CE of
``ops/ce_cuda.py`` with bf16 operands (the JAX package's ``fused_ce_logp``
default): ``ce_forward`` in evaluation, ``FusedCEFn`` (grad mode) in
training. Otherwise it is the JAX package's XLA branch on f32 logits:
``log_softmax`` + gather in training, gather - logsumexp in evaluation.
Under a profiler the fused CE call is the span ``ce``, with its device
time (utils/profiling.py). The JAX package routes to its CE kernel only when ``nh % 128 == 0`` (a TPU
lane tile) and V >= 1024; the port drops the tile gate and keeps the
vocab-size one (``ce_fusable``).

Generation runs one ``lstm_cell`` step at a time (never the kernel route,
as in the JAX package), all rows at once on the tensors' device:

- ``greedy_decode`` / ``sample_decode`` (``_generate``): ``max_len`` steps
  of argmax, or of argmax(logits + Gumbel), which is what the JAX package's
  ``categorical`` computes; a row emits PAD after its EOS. The Gumbel draws
  come from ``noise(step, shape)`` (a test hands in the JAX package's
  draws), else from ``generator``.
- ``beam_search_decode``: ``backend="device"`` is ``_beam_search_batched``,
  every row's beams in one batched step, one host read per step for the loop
  condition; ``backend="host"`` is ``_beam_search_host``, the reference's
  per-row loop on host numpy (``np.argpartition`` and Python's stable
  sort, so that ties fall as in the JAX package), kept as the oracle.
- ``_topk_small`` is ``lax.top_k``'s contract (descending, the lower index
  first among ties), as a stable sort; ``torch.topk`` promises no tie order.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.vocab import BOS_ID, EOS_ID, PAD_ID
from ..ops.ce_cuda import FusedCEFn, ce_forward
from ..utils.profiling import span
from .decoder import DecoderBase
from .lstm_core import LSTMParams, SeqInput, lstm_bias, lstm_cell, lstm_run, uniform_


Draw = Callable[[str, Tuple[int, ...]], torch.Tensor]
StepNoise = Callable[[int, Tuple[int, ...]], torch.Tensor]


def gumbel_noise(generator: Optional[torch.Generator], device) -> StepNoise:
    """Gumbel(0, 1) draws from ``generator`` as the JAX package's ``gumbel``
    makes them: -log(-log(u)), u uniform in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny

    def noise(step: int, shape: Tuple[int, ...]) -> torch.Tensor:
        u = torch.rand(shape, generator=generator, device=device)
        return -torch.log(-torch.log(u.clamp_(min=tiny)))

    return noise


def ce_fusable(vocab: int) -> bool:
    """Vocabularies large enough that the fused CE is the route (JAX: V >= 1024)."""
    return vocab >= 1024


def keep_mask(rate: float, draw: Optional[Draw], site: str,
              shape: Tuple[int, ...]) -> Optional[torch.Tensor]:
    """The keep-mask ``draw(site, shape) < 1 - rate`` of a dropout, or None
    outside training (no ``draw``) or at rate 0 (nothing is drawn)."""
    if draw is None or rate <= 0.0:
        return None
    return draw(site, shape) < 1.0 - rate


def apply_keep(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """``x / (1 - rate)`` where ``keep``, else 0; ``x`` when ``keep`` is None."""
    return x if keep is None else torch.where(keep, x / (1.0 - rate), 0.0)


class LSTMDecoder(DecoderBase):
    def __init__(self, vocab_size: int, ni: int, nh: int, nz: int,
                 dropout_in: float = 0.5, dropout_out: float = 0.5,
                 kernel_route: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size, self.ni, self.nh, self.nz = vocab_size, ni, nh, nz
        self.dropout_in, self.dropout_out = dropout_in, dropout_out
        self.kernel_route = kernel_route
        self.compute_dtype = compute_dtype
        self.fused_ce = kernel_route and ce_fusable(vocab_size)
        self.iw_chunk = 20 if self.fused_ce else 10
        self.emb = nn.Parameter(torch.empty(vocab_size, ni))
        self.lstm = LSTMParams(ni + nz, nh)
        self.trans = nn.Parameter(torch.empty(nz, nh))
        self.pred = nn.Parameter(torch.empty(nh, vocab_size))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init recipe: embeddings U(-0.1, 0.1), the rest U(-0.01, 0.01)."""
        uniform_(self.emb, 0.1, generator)
        self.lstm.reset_parameters(generator, 0.01)
        uniform_(self.trans, 0.01, generator)
        uniform_(self.pred, 0.01, generator)

    def _init_state(self, z_flat: torch.Tensor):
        """z [N, nz] -> (h0, c0): c0 = z @ trans, h0 = tanh(c0)."""
        c0 = z_flat @ self.trans
        return torch.tanh(c0), c0

    def _keep_masks(self, draw: Optional[Draw], suffix: str, B: int, T: int, k: int):
        """(keep_in [B, T, ni], keep_out [k*B, T, nh]) of one chunk, drawn at
        sites ``"keep_in" + suffix`` and ``"keep_out" + suffix``, in that order."""
        return (keep_mask(self.dropout_in, draw, "keep_in" + suffix, (B, T, self.ni)),
                keep_mask(self.dropout_out, draw, "keep_out" + suffix, (k * B, T, self.nh)))

    def _shared_input(self, tokens_in: torch.Tensor, draw: Optional[Draw]
                      ) -> Optional[SeqInput]:
        """The embeddings of ``tokens_in`` as one ``SeqInput`` for every
        z-chunk of a call, where no chunk draws an input dropout and no
        gradient is taken; else None (each chunk embeds its own)."""
        if torch.is_grad_enabled() or (draw is not None and self.dropout_in > 0.0):
            return None
        return SeqInput(self.emb[tokens_in])

    def _hidden_states(self, tokens_in: torch.Tensor, z: torch.Tensor,
                       keep_in: Optional[torch.Tensor] = None,
                       seq: Optional[SeqInput] = None) -> torch.Tensor:
        """tokens_in [B, T], z [B, K, nz] -> LSTM outputs [K*B, T, nh], row
        k*B + b. ``seq``: the embeddings shared by the call's chunks
        (``_shared_input``), else they are embedded here with ``keep_in``."""
        B = tokens_in.shape[0]
        K = z.shape[1]
        if seq is None:
            seq = SeqInput(apply_keep(self.emb[tokens_in], keep_in, self.dropout_in))
        z_flat = z.transpose(0, 1).reshape(K * B, self.nz)
        h0, c0 = self._init_state(z_flat)
        outs, _ = lstm_run(self.lstm, seq, None, h0, c0, kernel_route=self.kernel_route,
                           compute_dtype=self.compute_dtype, x_row=z_flat)
        return outs

    def _logits(self, tokens_in, z, keep_in=None, keep_out=None, seq=None) -> torch.Tensor:
        B, T = tokens_in.shape
        K = z.shape[1]
        cd = self.compute_dtype
        outs = apply_keep(self._hidden_states(tokens_in, z, keep_in, seq), keep_out,
                          self.dropout_out)
        logits = outs.reshape(-1, self.nh).to(cd).float() @ self.pred.to(cd).float()
        return logits.reshape(K, B, T, self.vocab_size).permute(1, 0, 2, 3)

    def decode(self, tokens_in: torch.Tensor, z: torch.Tensor,
               draw: Optional[Draw] = None) -> torch.Tensor:
        """Teacher-forced logits: tokens_in [B, T], z [B, K, nz] -> [B, K, T, V]
        (with dropout when ``draw`` is given)."""
        B, T = tokens_in.shape
        return self._logits(tokens_in, z, *self._keep_masks(draw, "", B, T, z.shape[1]))

    def reconstruct_error(self, tokens: torch.Tensor, mask: torch.Tensor,
                          z: torch.Tensor, draw: Optional[Draw] = None) -> torch.Tensor:
        """-log p(x|z) per (sentence, z-sample): [B, K].

        tokens [B, T] = <s> w1..wn </s> pad..; inputs tokens[:, :-1],
        targets tokens[:, 1:], target mask mask[:, 1:]. ``draw`` selects
        training mode: dropout, and the CE that takes a gradient."""
        B, T = tokens.shape
        train = draw is not None
        seq = self._shared_input(tokens[:, :-1], draw)

        def rec_chunk(z_chunk, keep_in, keep_out):  # [B, k, nz] -> [B, k]
            k = z_chunk.shape[1]
            if self.fused_ce:
                outs = apply_keep(self._hidden_states(tokens[:, :-1], z_chunk, keep_in, seq),
                                  keep_out, self.dropout_out)  # [k*B, T-1, nh]
                tgt = tokens[None, :, 1:].expand(k, B, T - 1).reshape(-1)
                h = outs.reshape(-1, self.nh)
                with span("ce", device=True):
                    if train:
                        logp = FusedCEFn.apply(h, self.pred, tgt, torch.bfloat16)
                    else:
                        logp, _ = ce_forward(h, self.pred, tgt, torch.bfloat16)
                tok_lp = logp.reshape(k, B, T - 1).transpose(0, 1)
            else:
                logits = self._logits(tokens[:, :-1], z_chunk, keep_in, keep_out, seq)
                tgt = tokens[:, None, 1:].expand(B, k, T - 1)[..., None]
                if train:
                    tok_lp = torch.log_softmax(logits, dim=-1).gather(-1, tgt)[..., 0]
                else:
                    tok_lp = logits.gather(-1, tgt)[..., 0] - torch.logsumexp(logits, dim=-1)
            return -torch.sum(tok_lp * mask[:, None, 1:], dim=-1)

        return self.over_chunks(rec_chunk, z, draw, T - 1)

    def over_chunks(self, rec_chunk: Callable, z: torch.Tensor, draw: Optional[Draw],
                    T: int) -> torch.Tensor:
        """``rec_chunk(z_chunk, keep_in, keep_out) -> [B, k]`` over z [B, K,
        nz] in chunks of ``iw_chunk`` samples -> [B, K] (module docstring:
        zero-z padding above one chunk, each chunk's dropout drawn at its
        sites before ``torch.utils.checkpoint`` when there is a gradient);
        ``T`` is the decoder's input length. Also the tensor-parallel
        likelihood's (parallel/tp.py)."""
        B, K = z.shape[:2]
        c = self.iw_chunk
        if K <= c:
            return rec_chunk(z, *self._keep_masks(draw, "", B, T, K))
        n_chunks = -(-K // c)
        if n_chunks * c != K:
            z = torch.cat([z, z.new_zeros((B, n_chunks * c - K, self.nz))], dim=1)
        grad = torch.is_grad_enabled()
        out = []
        for j in range(n_chunks):
            args = (z[:, j * c:(j + 1) * c], *self._keep_masks(draw, str(j), B, T, c))
            out.append(checkpoint(rec_chunk, *args, use_reentrant=False,
                                  preserve_rng_state=False) if grad else rec_chunk(*args))
        return torch.cat(out, dim=1)[:, :K]

    # ------------------------------------------------------------ generation
    def _step(self, tok: torch.Tensor, z: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              bias: torch.Tensor):
        """One decode step for every row: tokens [N], z [N, nz] -> (logits [N, V], h, c)."""
        xw = torch.cat([self.emb[tok], z], dim=-1) @ self.lstm.wx + bias
        h, c = lstm_cell(h, c, xw, self.lstm.wh, self.compute_dtype)
        return h @ self.pred, h, c

    @torch.no_grad()
    def _generate(self, z: torch.Tensor, max_len: int, noise: Optional[StepNoise]) -> torch.Tensor:
        """z [N, nz] -> token ids [N, max_len] (from after <s>; PAD after </s>);
        greedy without ``noise``."""
        N = z.shape[0]
        h, c = self._init_state(z)
        bias = lstm_bias(self.lstm)
        tok = torch.full((N,), BOS_ID, dtype=torch.long, device=z.device)
        done = torch.zeros((N,), dtype=torch.bool, device=z.device)
        out = []
        for t in range(max_len):
            logits, h, c = self._step(tok, z, h, c, bias)
            if noise is not None:
                logits = logits + noise(t, tuple(logits.shape))
            tok = torch.where(done, PAD_ID, torch.argmax(logits, dim=-1))
            done = done | (tok == EOS_ID)
            out.append(tok)
        return torch.stack(out, dim=1) if out else z.new_zeros((N, 0), dtype=torch.long)

    def greedy_decode(self, z: torch.Tensor, max_len: int = 100) -> torch.Tensor:
        return self._generate(z, max_len, None)

    def sample_decode(self, z: torch.Tensor, max_len: int = 100,
                      noise: Optional[StepNoise] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Ancestral sampling: ``noise(step, (N, V))`` gives step ``step``'s
        Gumbel draws; without it they come from ``generator``."""
        return self._generate(z, max_len, noise or gumbel_noise(generator, z.device))

    def beam_search_decode(self, z: torch.Tensor, beam_width: int = 5, max_len: int = 100,
                           backend: str = "device") -> List[List[int]]:
        """Beam search over a batch of latents; each row's hypothesis starts
        with <s> and ends with </s> when one finished within ``max_len``."""
        if backend == "device":
            toks, lens = self._beam_search_batched(z, beam_width, max_len)
            toks, lens = toks.tolist(), lens.tolist()
            return [row[:n] for row, n in zip(toks, lens)]
        if backend != "host":  # a typo must not silently pick the slow loop
            raise ValueError(f"unknown beam backend {backend!r}")
        return self._beam_search_host(z, beam_width, max_len)

    @torch.no_grad()
    def _beam_step(self, z, tok, h, c):
        logits, h, c = self._step(tok, z, h, c, lstm_bias(self.lstm))
        return torch.log_softmax(logits, dim=-1), h, c

    @torch.no_grad()
    def _beam_search_host(self, z: torch.Tensor, beam_width: int = 5,
                          max_len: int = 100) -> List[List[int]]:
        """The reference's BeamSearchNode loop, one row of z at a time."""
        results = []
        for n in range(z.shape[0]):
            zn = z[n:n + 1]
            beams = [([BOS_ID], 0.0, self._init_state(zn))]  # (tokens, logp, state)
            done: List[Tuple[List[int], float]] = []
            for _ in range(max_len):
                cand = []
                for toks, lp, (h, c) in beams:
                    logp, h2, c2 = self._beam_step(
                        zn, torch.tensor([toks[-1]], device=z.device), h, c)
                    logp = logp[0].cpu().numpy()
                    if beam_width < logp.shape[-1]:
                        top = np.argpartition(-logp, beam_width)[:beam_width]
                    else:  # tiny vocab: expand every token
                        top = np.arange(logp.shape[-1])
                    for t in top:
                        cand.append((toks + [int(t)], lp + float(logp[t]), (h2, c2)))
                cand.sort(key=lambda x: -x[1])
                beams = []
                for toks, lp, st in cand[: beam_width * 2]:
                    if toks[-1] == EOS_ID:
                        done.append((toks, lp / len(toks)))
                    else:
                        beams.append((toks, lp, st))
                    if len(beams) >= beam_width:
                        break
                if not beams or len(done) >= beam_width:
                    break
            if not done:
                done = [(b[0], b[1] / len(b[0])) for b in beams]
            done.sort(key=lambda x: -x[1])
            results.append(done[0][0])
        return results

    @torch.no_grad()
    def _beam_search_batched(self, z: torch.Tensor, beam_width: int, max_len: int):
        """All rows' beams in one batched step, as the JAX package's
        ``_beam_search_batched``: returns ``(toks [N, max_len + 1], lens
        [N])``, row n's hypothesis being ``toks[n, :lens[n]]``.

        Each step merges every live beam's top-``beam_width`` continuations,
        keeps the best ``2 * beam_width`` (the reference's candidate window)
        and scans them in score order: EOS-ending candidates become finished
        hypotheses scored by length-normalized logp, the rest refill the
        live-beam slots until ``beam_width`` are filled (a cumulative count
        over the sorted window in place of the host loop's break). A row ends
        when ``beam_width`` hypotheses have finished or no beam is live.
        Candidates whose total logp is -inf are dropped, as there."""
        V, N, dev = self.vocab_size, z.shape[0], z.device
        K = W = int(beam_width)
        C1 = min(W, V)            # per-beam expansions (host: top-W / whole tiny vocab)
        C2 = min(2 * W, K * C1)   # sorted candidate window (host: cand[:2W])
        T = max_len + 1           # BOS + at most max_len generated tokens
        NEG = float("-inf")
        bias = lstm_bias(self.lstm)
        h0, c0 = self._init_state(z)

        def expand(a):  # [N, ...] -> [N, K, ...] beam copies
            return a[:, None].expand(N, K, *a.shape[1:])

        def rows(a, idx):  # a [N, K, ...] at beam indices idx [N, J] -> [N, J, ...]
            return a.gather(1, idx.view(N, -1, *([1] * (a.dim() - 2))).expand(
                N, idx.shape[1], *a.shape[2:]))

        z_rep = expand(z).reshape(N * K, -1)
        ar_k = torch.arange(K, device=dev)
        slot0 = (ar_k == 0).expand(N, K)
        ar_t = torch.arange(T, device=dev)
        toks = torch.full((N, K, T), PAD_ID, dtype=torch.long, device=dev)
        toks[:, :, 0] = BOS_ID
        lens = torch.ones((N, K), dtype=torch.long, device=dev)
        lp = torch.where(slot0, 0.0, NEG)
        live = slot0
        last = torch.full((N, K), BOS_ID, dtype=torch.long, device=dev)
        h, c = expand(h0), expand(c0)
        done_count = torch.zeros((N,), dtype=torch.long, device=dev)
        best_score = torch.full((N,), NEG, device=dev)
        best_toks = torch.full((N, T), PAD_ID, dtype=torch.long, device=dev)
        best_len = torch.zeros((N,), dtype=torch.long, device=dev)
        finished = torch.zeros((N,), dtype=torch.bool, device=dev)

        t = 0
        while t < max_len and not bool(finished.all()):  # one host read a step
            logits, h2, c2 = self._step(last.reshape(-1), z_rep, h.reshape(N * K, -1),
                                        c.reshape(N * K, -1), bias)
            logp = torch.log_softmax(logits, dim=-1).reshape(N, K, V)
            h2, c2 = h2.reshape(N, K, -1), c2.reshape(N, K, -1)

            top_lp, top_tok = _topk_small(logp, C1)                  # [N, K, C1]
            cand = torch.where(live[:, :, None], lp[:, :, None] + top_lp, NEG)
            cs, ci = _topk_small(cand.reshape(N, K * C1), C2)        # [N, C2] desc
            beam_i = ci // C1
            tok_i = top_tok.reshape(N, K * C1).gather(1, ci)

            valid = cs > NEG
            is_eos = valid & (tok_i == EOS_ID)
            live_inc = (valid & (tok_i != EOS_ID)).long()
            cum_excl = torch.cumsum(live_inc, dim=1) - live_inc
            processed = cum_excl < W          # host stops once W live slots fill

            # refill the K live-beam slots from the processed prefix
            sel = processed & live_inc.bool()
            slot_match = sel[:, None, :] & (cum_excl[:, None, :] == ar_k[None, :, None])
            has = slot_match.any(-1)                                  # [N, K]
            src = slot_match.long().argmax(-1)                        # index into C2
            parent = beam_i.gather(1, src)
            new_tok = tok_i.gather(1, src)
            new_lp = torch.where(has, cs.gather(1, src), NEG)
            new_toks = rows(toks, parent)
            new_lens = lens.gather(1, parent)
            new_toks = torch.where(ar_t[None, None] == new_lens[:, :, None],
                                   new_tok[:, :, None], new_toks)
            new_lens = new_lens + 1

            # finished hypotheses: EOS candidates within the processed prefix,
            # scored by length-normalized total logp (len counts BOS..EOS)
            eos_sel = processed & is_eos
            cand_len = lens.gather(1, beam_i) + 1
            norm = torch.where(eos_sel, cs / cand_len, NEG)
            step_best, bi = norm.max(1).values, norm.argmax(1)
            bparent = beam_i.gather(1, bi[:, None])
            btoks = rows(toks, bparent)[:, 0]
            blen = lens.gather(1, bparent)[:, 0]
            btoks = torch.where(ar_t[None] == blen[:, None], EOS_ID, btoks)
            improve = (step_best > best_score) & ~finished

            done_count = done_count + torch.where(finished, 0, eos_sel.sum(1))
            frz = finished                    # rows frozen BEFORE this step
            finished = finished | (done_count >= W) | ~has.any(1)

            def keep(old, new):
                return torch.where(frz.view(N, *([1] * (new.dim() - 1))), old, new)

            toks, lens, lp, live, last = (keep(toks, new_toks), keep(lens, new_lens),
                                          keep(lp, new_lp), keep(live, has),
                                          keep(last, new_tok))
            h, c = keep(h, rows(h2, parent)), keep(c, rows(c2, parent))
            best_score = torch.where(improve, step_best, best_score)
            best_toks = torch.where(improve[:, None], btoks, best_toks)
            best_len = torch.where(improve, blen + 1, best_len)
            t += 1

        # rows with no finished hypothesis fall back to the best live beam,
        # normalized by its current length (host: `if not done: done = beams`)
        li = torch.where(live, lp / lens, NEG).argmax(1)
        ltoks = rows(toks, li[:, None])[:, 0]
        llen = lens.gather(1, li[:, None])[:, 0]
        use_done = done_count > 0
        return (torch.where(use_done[:, None], best_toks, ltoks),
                torch.where(use_done, best_len, llen))


def _topk_small(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: values descending, the lower index
    first among ties (-inf included). A stable descending sort keeps equal
    values in index order; ``torch.topk`` promises no order among ties."""
    vals, idxs = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idxs[..., :k]
