"""The LSTM's input product taken in two parts (``models/lstm_core.py``).

``lstm_run`` projects a per-sentence sequence ``x`` and a per-row constant
``x_row`` apart and writes ``xw`` once, in the kernel's [T, rows, 4H]
layout; the decoder passes its embeddings and z so, and shares the
embeddings' product between the z-chunks of one evaluation. Held here
against the single product of the concatenated input that it replaces
(``_concat_lstm_run``, ``_concat_hidden_states``), on both routes, with and
without drawn dropout, at one z-sample, one chunk and a padded last chunk:
outputs and gradients within 1e-5 of the largest value. Also: ``xw`` is
one contiguous write with no copy after it, and the counter
``lstm.input_rows_shared`` adds the rows assembled less the sentence rows
computed. Imports neither JAX nor the JAX package.
"""
import zlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from vae_lagging_encoder_tpu_torch.models import LSTMDecoder
from vae_lagging_encoder_tpu_torch.models import lstm_core
from vae_lagging_encoder_tpu_torch.models.dec_lstm import apply_keep
from vae_lagging_encoder_tpu_torch.models.lstm_core import LSTMParams, SeqInput, lstm_bias, lstm_run
from vae_lagging_encoder_tpu_torch.ops.lstm_cuda import LSTMSeqFn, lstm_seq, lstm_seq_plain
from vae_lagging_encoder_tpu_torch.utils import profiling

NI, NZ, NH, B, T = 8, 4, 16, 3, 7
TOL = 1e-5


def _concat_lstm_run(params, x, mask=None, h0=None, c0=None, kernel_route=False,
                     compute_dtype=torch.float32):
    """The single-product ``lstm_run``: ``[x] @ wx``, the bias added, the
    result transposed and copied to [T, B, 4H]."""
    Bx, Tx, _ = x.shape
    H = params.wh.shape[0]
    cd = compute_dtype
    xw = x.reshape(Bx * Tx, -1).to(cd).float() @ params.wx.to(cd).float()
    xw = (xw.reshape(Bx, Tx, 4 * H) + lstm_bias(params)).transpose(0, 1)
    m = mask.transpose(0, 1) if mask is not None else x.new_ones((Tx, Bx))
    h0 = x.new_zeros((Bx, H)) if h0 is None else h0
    c0 = x.new_zeros((Bx, H)) if c0 is None else c0
    if not kernel_route:
        hs, hT, cT = lstm_seq_plain(xw, m, params.wh.to(cd), h0, c0)
    else:
        wh = params.wh.to(torch.bfloat16 if (H > 512 or cd == torch.bfloat16)
                          else torch.float32)
        needs_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (xw, wh, h0, c0))
        run = LSTMSeqFn.apply if needs_grad else lstm_seq
        hs, hT, cT = run(xw.contiguous(), m.contiguous(), wh, h0, c0)
    return hs.transpose(0, 1), (hT, cT)


def _concat_hidden_states(dec, tokens_in, z, keep_in=None, seq=None):
    """The decoder's LSTM on ``cat([emb expanded K times, z at every step])``."""
    Bt, Tt = tokens_in.shape
    K = z.shape[1]
    emb = seq.x if seq is not None else apply_keep(dec.emb[tokens_in], keep_in, dec.dropout_in)
    emb_k = emb[None].expand(K, Bt, Tt, dec.ni).reshape(K * Bt, Tt, dec.ni)
    z_flat = z.transpose(0, 1).reshape(K * Bt, dec.nz)
    z_seq = z_flat[:, None, :].expand(K * Bt, Tt, dec.nz)
    h0, c0 = dec._init_state(z_flat)
    outs, _ = _concat_lstm_run(dec.lstm, torch.cat([emb_k, z_seq], dim=-1), None, h0, c0,
                               kernel_route=dec.kernel_route, compute_dtype=dec.compute_dtype)
    return outs


def _close(got, want, what):
    got, want = got.detach(), want.detach()
    err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
    assert err <= TOL, f"{what}: {err:.3g}"


def _draw(site, shape):
    g = torch.Generator().manual_seed(zlib.crc32(site.encode()))
    return torch.rand(shape, generator=g)


def _decoder(vocab, kernel_route=True, dropout=0.5):
    dec = LSTMDecoder(vocab, NI, NH, NZ, dropout_in=dropout, dropout_out=dropout,
                      kernel_route=kernel_route)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in dec.parameters():
            p.uniform_(-0.5, 0.5, generator=g)
    return dec


def _tokens(vocab, seed=1):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(4, vocab, (B, T + 1), generator=g)
    mask = torch.ones((B, T + 1))
    mask[1, 5:] = 0.0
    mask[2, 3:] = 0.0
    return tokens, mask


@pytest.mark.parametrize("kernel_route", [False, True])
@pytest.mark.parametrize("K", [None, 1, 20])
def test_lstm_run_in_two_parts_matches_the_concatenated_product(K, kernel_route):
    """Outputs, carries and the gradients of every input and parameter;
    ``K`` None is the encoder's call (no ``x_row``)."""
    torch.manual_seed(0)
    d_row = 0 if K is None else NZ
    p = LSTMParams(NI + d_row, NH)
    with torch.no_grad():
        for t in p.parameters():
            t.uniform_(-0.5, 0.5)
    N = B * (K or 1)
    x = torch.randn(B, T, NI, requires_grad=True)
    x_row = None if K is None else torch.randn(N, d_row, requires_grad=True)
    mask = torch.ones(N, T)
    mask[1, 4:] = 0.0
    h0 = torch.randn(N, NH, requires_grad=True)
    c0 = torch.randn(N, NH, requires_grad=True)
    out, (hT, cT) = lstm_run(p, x, mask, h0, c0, kernel_route=kernel_route, x_row=x_row)
    x_cat = x.repeat(K or 1, 1, 1)
    if x_row is not None:
        x_cat = torch.cat([x_cat, x_row[:, None].expand(N, T, d_row)], dim=-1)
    want, (hT_w, cT_w) = _concat_lstm_run(p, x_cat, mask, h0, c0, kernel_route=kernel_route)
    ct = torch.randn_like(want)
    leaves = [x, h0, c0, *p.parameters()] + ([x_row] if x_row is not None else [])
    got_g = torch.autograd.grad((out * ct).sum() + hT.sum() + cT.sum(), leaves)
    want_g = torch.autograd.grad((want * ct).sum() + hT_w.sum() + cT_w.sum(), leaves)
    _close(out, want, "outputs")
    _close(hT, hT_w, "h_T")
    _close(cT, cT_w, "c_T")
    for i, (a, b) in enumerate(zip(got_g, want_g)):
        _close(a, b, f"gradient {i}")


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("K", [1, 20])
def test_decoder_hidden_states_match_the_concatenated_input(K, dropout):
    """``_hidden_states`` and its gradients (wx, wh, the biases, emb, z, trans)
    with drawn ``keep_in`` / ``keep_out`` or none."""
    dec = _decoder(1030)
    tokens, _ = _tokens(1030)
    z = torch.randn(B, K, NZ, requires_grad=True)
    draw = _draw if dropout else None
    keep_in, keep_out = dec._keep_masks(draw, "", B, T, K)
    assert (keep_in is None) != dropout

    def run(hidden):
        outs = hidden(dec, tokens[:, :-1], z, keep_in)
        return apply_keep(outs, keep_out, dec.dropout_out)

    got = run(LSTMDecoder._hidden_states)
    want = run(_concat_hidden_states)
    ct = torch.randn_like(want)
    leaves = [z, dec.emb, dec.trans, dec.lstm.wx, dec.lstm.wh, dec.lstm.b_ih, dec.lstm.b_hh]
    _close(got, want, "outputs")
    for leaf, a, b in zip(leaves, torch.autograd.grad((got * ct).sum(), leaves),
                          torch.autograd.grad((want * ct).sum(), leaves)):
        _close(a, b, f"gradient of {tuple(leaf.shape)}")


@pytest.mark.parametrize("mode", ["eval", "eval_grad", "train"])
@pytest.mark.parametrize("K,vocab", [(1, 1030), (20, 1030), (25, 1030), (25, 50)])
def test_reconstruct_error_matches_the_concatenated_input(monkeypatch, K, vocab, mode):
    """Through the z-chunks: K 25 is two chunks of 20 (fused CE) or three of
    10 (the f32 logits), the last padded. ``eval`` shares the embeddings'
    product between the chunks; ``eval_grad`` and ``train`` (drawn dropout)
    checkpoint each chunk, which computes its own."""
    dec = _decoder(vocab)
    tokens, mask = _tokens(vocab)
    z = torch.randn(B, K, NZ, requires_grad=mode != "eval")
    draw = _draw if mode == "train" else None
    leaves = [z, dec.emb, dec.trans, dec.pred, dec.lstm.wx, dec.lstm.b_ih, dec.lstm.b_hh]

    def run():
        with torch.set_grad_enabled(mode != "eval"):
            rec = dec.reconstruct_error(tokens, mask, z, draw=draw)
            ct = torch.linspace(0.5, 1.5, rec.numel()).reshape(rec.shape)
            return rec, (None if mode == "eval" else torch.autograd.grad((rec * ct).sum(), leaves))

    got, got_g = run()
    monkeypatch.setattr(LSTMDecoder, "_hidden_states", _concat_hidden_states)
    want, want_g = run()
    assert got.shape == (B, K)
    _close(got, want, "-log p(x|z)")
    for leaf, a, b in zip(leaves, got_g or (), want_g or ()):
        _close(a, b, f"gradient of {tuple(leaf.shape)}")


class _Writes(TorchDispatchMode):
    """The ops that write a tensor of ``numel`` elements: into new memory,
    or in place (a view writes nothing)."""

    def __init__(self, numel):
        super().__init__()
        self.numel, self.ops = numel, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.numel() == self.numel:
            inputs = {a.untyped_storage().data_ptr() for a in args if isinstance(a, torch.Tensor)}
            if func._schema.is_mutable or out.untyped_storage().data_ptr() not in inputs:
                self.ops.append(func.overloadpacket.__name__)
        return out


@pytest.mark.parametrize("kernel_route", [False, True])
@pytest.mark.parametrize("K", [None, 1, 20])
def test_xw_is_one_contiguous_write_in_the_kernel_layout(monkeypatch, K, kernel_route):
    """The recurrence gets ``xw`` as a contiguous [T, rows, 4H] tensor made
    by one add after the products (the bias, or the broadcast of z's
    product), with no copy of that size before or after it; without
    ``x_row`` or at one z-sample the sentences' product is of that size
    too."""
    seen = []

    def recurrence(xw, mask, wh, h0, c0, *rest):
        seen.append(xw)
        z = xw.new_zeros((xw.shape[0], xw.shape[1], NH))
        return z, z[0], z[0]

    monkeypatch.setattr(lstm_core, "lstm_seq_plain", recurrence)
    monkeypatch.setattr(lstm_core, "lstm_seq", recurrence)
    monkeypatch.setattr(LSTMSeqFn, "apply", recurrence)
    p = LSTMParams(NI + (0 if K is None else NZ), NH)
    with torch.no_grad():
        for t in p.parameters():
            t.uniform_(-0.5, 0.5)
    N = B * (K or 1)
    x = torch.randn(B, T, NI)
    x_row = None if K is None else torch.randn(N, NZ)
    mode = _Writes(T * N * 4 * NH)
    with mode:
        lstm_run(p, x, kernel_route=kernel_route, x_row=x_row)
    (xw,) = seen
    assert xw.shape == (T, N, 4 * NH) and xw.is_contiguous()
    assert mode.ops == (["add"] if K == 20 else ["mm", "add"])


def _profiled(fn):
    profiling.take()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return profiling.take()


def test_input_rows_shared_counts_the_rows_not_computed():
    """One IW chunk of 100 samples over B sentences is five decoder calls of
    20 * B rows that compute the B sentences' product once: 100 * B - B
    rows shared, one ``lstm.input_proj`` span a call. A training step at
    one z-sample shares none; one at 40 (two chunks, drawn dropout) shares
    each chunk's 20 * B - B, in the chunk's forward and again in its
    recompute under the backward."""
    dec = _decoder(1030)
    assert dec.iw_chunk == 20
    tokens, mask = _tokens(1030)

    with torch.no_grad():
        state = _profiled(lambda: dec.reconstruct_error(tokens, mask, torch.randn(B, 100, NZ)))
    assert state["counters"]["lstm.input_rows_shared"] == 100 * B - B
    assert [s["name"] for s in state["spans"]].count("lstm.input_proj") == 5

    for K, shared in ((1, 0), (40, 2 * 2 * (20 * B - B))):
        z = torch.randn(B, K, NZ, requires_grad=True)
        state = _profiled(
            lambda: dec.reconstruct_error(tokens, mask, z, draw=_draw).sum().backward())
        assert state["counters"].get("lstm.input_rows_shared", 0) == shared, K


def test_shared_input_only_without_input_dropout_and_gradient():
    dec = _decoder(1030)
    tokens, _ = _tokens(1030)
    with torch.no_grad():
        seq = dec._shared_input(tokens, None)
        assert isinstance(seq, SeqInput) and seq.proj is None
        assert torch.equal(seq.x, dec.emb[tokens])
        assert dec._shared_input(tokens, _draw) is None
        assert isinstance(_decoder(1030, dropout=0.0)._shared_input(tokens, _draw), SeqInput)
    assert dec._shared_input(tokens, None) is None  # a gradient: each chunk its own
