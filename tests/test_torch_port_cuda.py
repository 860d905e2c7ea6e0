"""The CUDA kernels against their plain PyTorch versions, on a CUDA device.

Marked ``cuda``: each test skips where torch.cuda.is_available() is false
(a CUDA kernel has no CPU mode). This file imports neither JAX nor the JAX
package, so it runs on a GPU machine without them; ``tests/conftest.py``
imports JAX, hence:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Small odd shapes: partial row tiles, partial hidden-unit blocks, a ragged
last vocab tile; the bf16 CE under a plan whose segments split a row group,
equal bits across calls, and a plan the card cannot hold. The CE backward (``csrc/ce_bwd.cu``) at a small shape and
the training shape, bit-equal across calls, through ``FusedCEFn`` against
the CPU, and its extra peak memory. Generation (plain PyTorch on the card) against the same
calls on the CPU: the top-k tie order, greedy and beam decoding, the
incremental PixelCNN sampler. ``tp_token_logp`` over two ranks sharing
the card against the plain CE. The span recorder (utils/profiling.py) on a
graphed epoch: the trace's clock, no event inside a capture, the same
launch counts with tracing on. Tolerances: f32 operands differ only in summation order;
bf16 ``wh`` lets a last-bit difference in h (forward) or da (backward) flip
a bf16 rounding of the next step's product input (see chip_smoke.py for the
Yahoo-width checks).
"""
import dataclasses

import numpy as np
import pytest
import torch

from vae_lagging_encoder_tpu_torch.models import LSTMDecoder, PixelCNNDecoderV2, dec_lstm
from vae_lagging_encoder_tpu_torch.ops import build, ce_cuda, lstm_cuda


def _ce_inputs(n, nh, vocab, seed):
    rng = np.random.RandomState(seed)
    h = (rng.randn(n, nh) * 0.4).astype(np.float32)
    w = (rng.randn(nh, vocab) * 0.05).astype(np.float32)
    tgt = rng.randint(0, vocab, n).astype(np.int32)
    return h, w, tgt


def _launch_key(name, wh_dtype):
    """The ``LAUNCHES`` entry of an LSTM wrapper's launch: with f32 wh the
    f32-wh kernel's (``*_f32``)."""
    return name + ("_f32" if wh_dtype == torch.float32 else "")


@pytest.mark.cuda
@pytest.mark.parametrize("save_residuals", [False, True])
@pytest.mark.parametrize("wh_dtype", [torch.float32, torch.bfloat16])
def test_lstm_kernel_matches_plain_on_cuda(save_residuals, wh_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator().manual_seed(0)
    T, B, H = 7, 37, 200  # odd sizes: partial row tiles and unit blocks
    xw = torch.randn(T, B, 4 * H, generator=g).cuda()
    mask = (torch.rand(T, B, generator=g) > 0.3).float().cuda()
    wh = (0.1 * torch.randn(H, 4 * H, generator=g)).to(wh_dtype).cuda()
    h0, c0 = (0.1 * torch.randn(B, H, generator=g)).cuda(), torch.zeros(B, H).cuda()
    key = _launch_key("lstm_fwd_residuals" if save_residuals else "lstm_fwd_infer", wh_dtype)
    n = build.LAUNCHES[key]
    got = lstm_cuda.lstm_seq(xw, mask, wh, h0, c0, save_residuals)
    ref = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, save_residuals)
    torch.cuda.synchronize()
    assert build.LAUNCHES[key] == n + 1
    tol = 1e-5 if wh_dtype == torch.float32 else 2e-3
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_ce_kernel_matches_plain_on_cuda(bf16):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    h, w, tgt = _ce_inputs(n=70, nh=40, vocab=1100, seed=2)
    dt = torch.bfloat16 if bf16 else None
    args = (torch.from_numpy(h).cuda(), torch.from_numpy(w).cuda(), torch.from_numpy(tgt).cuda())
    got = ce_cuda.ce_forward(*args, dt)
    ref = ce_cuda.ce_logp_plain(*args, dt)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [160, 163, 600, 640])
def test_lstm_infer_tensor_core_plans_match_plain_on_cuda(rows):
    """The bf16 forward without residuals (csrc/lstm_infer.cu) at several
    m-tiles per block (163: a partial last tile; 600: a short second row
    group), H 256, under the plan ``lstm_seq`` picks (the wide plan from
    ``WIDE_MIN_ROWS`` rows), the mma.sync plan (8 units a block), and the
    plans for a card with 16 SMs (mma.sync: 16 units a block, as H > 8 x
    the SM count needs; wide: one row group)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator().manual_seed(7)
    T, H = 9, 256
    xw = torch.randn(T, rows, 4 * H, generator=g).cuda()
    mask = (torch.rand(T, rows, generator=g) > 0.3).float().cuda()
    wh = (0.1 * torch.randn(H, 4 * H, generator=g)).bfloat16().cuda()
    h0, c0 = (0.1 * torch.randn(rows, H, generator=g)).cuda(), torch.zeros(rows, H).cuda()
    ref = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0)
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    plan16 = lstm_cuda.mma_infer_plan(rows, H, 16)
    assert plan16.n_sub == 2
    plans = [lstm_cuda.mma_infer_plan(rows, H, nsm), plan16,
             lstm_cuda.wide_plan("infer", rows, H, nsm),
             lstm_cuda.wide_plan("infer", rows, H, 16)]
    assert isinstance(plans[2], lstm_cuda.WidePlan) and isinstance(plans[3], lstm_cuda.WidePlan)
    runs = [lambda: lstm_cuda.lstm_seq(xw, mask, wh, h0, c0)] + [
        lambda p=p: lstm_cuda.lstm_infer(xw, mask, wh, h0, c0, p) for p in plans]
    for run in runs:
        n = build.LAUNCHES["lstm_fwd_infer"]
        got = run()
        torch.cuda.synchronize()
        assert build.LAUNCHES["lstm_fwd_infer"] == n + 1
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, atol=2e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [20, 64])
def test_lstm_residual_forward_matches_plain_on_cuda(B):
    """The bf16 residual-saving forward (csrc/lstm_infer.cu with
    kSaveResiduals) at a short last batch (B 20: a partial m-tile pair) and
    B 64 (four m-tiles), H 256, under the plan ``lstm_seq`` picks (8 units a
    block) and the plan for a card with 16 SMs (16 units a block): hs, cs,
    gates, hT and cT against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator().manual_seed(11)
    T, H = 9, 256
    xw = torch.randn(T, B, 4 * H, generator=g).cuda()
    mask = (torch.rand(T, B, generator=g) > 0.3).float().cuda()
    wh = (0.1 * torch.randn(H, 4 * H, generator=g)).bfloat16().cuda()
    h0 = (0.1 * torch.randn(B, H, generator=g)).cuda()
    c0 = (0.1 * torch.randn(B, H, generator=g)).cuda()
    ref = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, True)
    plan16 = lstm_cuda.mma_infer_plan(B, H, 16, save_residuals=True)
    assert plan16.n_sub == 2
    runs = [lambda: lstm_cuda.lstm_seq(xw, mask, wh, h0, c0, True),
            lambda: lstm_cuda.lstm_infer(xw, mask, wh, h0, c0, plan16, True)]
    for run in runs:
        n = dict(build.LAUNCHES)
        got = run()
        torch.cuda.synchronize()
        assert build.LAUNCHES["lstm_fwd_residuals"] == n["lstm_fwd_residuals"] + 1
        assert build.LAUNCHES["lstm_fwd_infer"] == n["lstm_fwd_infer"]
        assert len(got) == 5
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, atol=2e-3, rtol=0)


@pytest.mark.cuda
def test_lstm_fwd_refuses_bf16_wh_on_cuda():
    """csrc/lstm_f32.cu takes only f32 wh: its wrapper refuses bf16 wh (the
    tensor-core lstm_infer.cu takes it), and its C entry point refuses a
    plan it was not built for (16 units a block), which raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    T, B, H = 3, 4, 16
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    xw, mask = torch.zeros(T, B, 4 * H, device="cuda"), torch.ones(T, B, device="cuda")
    wh = torch.zeros(H, 4 * H, device="cuda", dtype=torch.bfloat16)
    h0, c0 = torch.zeros(B, H, device="cuda"), torch.zeros(B, H, device="cuda")
    plan = lstm_cuda.f32_plan("infer", B, H, nsm)
    for save in (False, True):
        with pytest.raises(ValueError, match="lstm_fwd_f32"):
            lstm_cuda.lstm_fwd_f32(xw, mask, wh, h0, c0, plan, save)
        with pytest.raises(RuntimeError, match="lstm_fwd_f32"):
            lstm_cuda.lstm_fwd_f32(xw, mask, wh.float(), h0, c0,
                                   dataclasses.replace(plan, units=16), save)


def _lstm_bwd_inputs(T, B, H, wh_dtype, seed):
    g = torch.Generator().manual_seed(seed)
    xw = torch.randn(T, B, 4 * H, generator=g)
    mask = (torch.rand(T, B, generator=g) > 0.3).float()
    wh = (0.1 * torch.randn(H, 4 * H, generator=g)).to(wh_dtype)
    h0, c0 = 0.1 * torch.randn(B, H, generator=g), 0.1 * torch.randn(B, H, generator=g)
    hs, cs, gates, _, _ = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, True)
    c_prev = torch.cat([c0[None], cs[:-1]])
    dhs = 0.1 * torch.randn(T, B, H, generator=g)
    dhT, dcT = 0.1 * torch.randn(B, H, generator=g), 0.1 * torch.randn(B, H, generator=g)
    return [a.cuda() for a in (gates, mask, wh, c_prev, dhs, dhT, dcT)]


@pytest.mark.cuda
@pytest.mark.parametrize("wh_dtype", [torch.float32, torch.bfloat16])
def test_lstm_bwd_kernel_matches_plain_on_cuda(wh_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    args = _lstm_bwd_inputs(7, 37, 200, wh_dtype, seed=3)
    key = _launch_key("lstm_bwd", wh_dtype)
    n = build.LAUNCHES[key]
    got = lstm_cuda.lstm_bwd(*args)
    ref = lstm_cuda.lstm_bwd_plain(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES[key] == n + 1
    # f32: summation order only (~1e-7 here); bf16: a flipped rounding of one
    # da value (~1e-3 relative) times a wh entry of ~0.1
    tol = 1e-5 if wh_dtype == torch.float32 else 1e-3
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [20, 64])
@pytest.mark.parametrize("wh_dtype", [torch.float32, torch.bfloat16])
def test_lstm_bwd_kernel_matches_plain_at_batch_sizes_on_cuda(B, wh_dtype):
    """A short last batch (B 20: one partial m-tile pair) and B 64 (four
    m-tiles in one pass) at H 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    args = _lstm_bwd_inputs(7, B, 256, wh_dtype, seed=4)
    key = _launch_key("lstm_bwd", wh_dtype)
    n = build.LAUNCHES[key]
    got = lstm_cuda.lstm_bwd(*args)
    ref = lstm_cuda.lstm_bwd_plain(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES[key] == n + 1
    # the tolerances of test_lstm_bwd_kernel_matches_plain_on_cuda
    tol = 1e-5 if wh_dtype == torch.float32 else 1e-3
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_ce_train_kernel_matches_plain_on_cuda(bf16):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    h, w, tgt = _ce_inputs(n=70, nh=40, vocab=1100, seed=5)
    dt = torch.bfloat16 if bf16 else None
    args = (torch.from_numpy(h).cuda(), torch.from_numpy(w).cuda(), torch.from_numpy(tgt).cuda())
    n = build.LAUNCHES["ce_fwd_train"]
    logp, lse, spill = ce_cuda.ce_forward(*args, dt, save_logits=True)
    rlogp, rlse, rspill = ce_cuda.ce_logp_plain(*args, dt, save_logits=True)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ce_fwd_train"] == n + 1
    assert spill.dtype == (torch.bfloat16 if bf16 else torch.float32)
    torch.testing.assert_close(logp, rlogp, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    # the spill: one f32 logit rounded to bf16 may land one bf16 step apart
    torch.testing.assert_close(spill.float(), rspill.float(), atol=2e-3 if bf16 else 1e-5, rtol=0)


@pytest.mark.cuda
def test_lstm_run_gradient_through_kernel_on_cuda():
    """A gradient through ``lstm_run``'s kernel route launches the forward
    (residuals) and backward kernels (H 16 in f32: the f32-wh kernels) and
    matches the plain route's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from vae_lagging_encoder_tpu_torch.models.lstm_core import LSTMParams, lstm_run

    p = LSTMParams(6, 16)
    p.reset_parameters(torch.Generator().manual_seed(0), scale=0.3)
    p = p.cuda()
    x = torch.randn(3, 4, 6, device="cuda")
    mask = torch.tensor([[1, 1, 1, 1], [1, 1, 0, 0], [1, 1, 1, 0]], device="cuda").float()
    grads = []
    for kernel_route in (True, False):
        n = dict(build.LAUNCHES)
        p.zero_grad()
        out, (hT, cT) = lstm_run(p, x, mask, kernel_route=kernel_route)
        ((out * mask[..., None]).square().sum() + hT.sum() + cT.square().sum()).backward()
        grads.append([q.grad.clone() for q in p.parameters()])
        launched = {k: build.LAUNCHES[k] - n[k] for k in n}
        if kernel_route:
            assert launched["lstm_fwd_residuals_f32"] == 1 and launched["lstm_bwd_f32"] == 1, \
                launched
        else:
            assert not any(launched.values()), launched
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    with torch.no_grad():
        n = build.LAUNCHES["lstm_fwd_infer_f32"]
        lstm_run(p, x, kernel_route=True)
        assert build.LAUNCHES["lstm_fwd_infer_f32"] == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("n", [1000, 3040])
def test_ce_kernel_at_yahoo_width_on_cuda(n, save):
    """The bf16 CE at nh 1024, V 20004 (a ragged last vocab tile): N 3040
    (the training shape: 12 row groups, most split between the persistent
    clusters mid-vocab)
    and N 1000 (a ragged last row tile), both modes; the spill is the
    [N, V] view of the padded [N, Vp] buffer. Tolerances: chip_smoke.py's
    CE checks (bf16 operands: summation order only; the spill within one
    bf16 step)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    h, w, tgt = _ce_inputs(n=n, nh=1024, vocab=20004, seed=n)
    args = (torch.from_numpy(h).cuda(), torch.from_numpy(w).cuda(), torch.from_numpy(tgt).cuda())
    name = "ce_fwd_train" if save else "ce_fwd"
    launches = build.LAUNCHES[name]
    got = ce_cuda.ce_forward(*args, torch.bfloat16, save_logits=save)
    ref = ce_cuda.ce_logp_plain(*args, torch.bfloat16, save_logits=save)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == launches + 1
    torch.testing.assert_close(got[0], ref[0], atol=1e-3, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=1e-3, rtol=0)
    if save:
        spill, rspill = got[2], ref[2]
        assert spill.shape == (n, 20004) and spill.dtype == torch.bfloat16
        d = (spill.float() - rspill.float()).abs()
        assert bool((d <= 2.0 ** -7 * rspill.float().abs() + 1e-5).all())


@pytest.mark.cuda
def test_tp_token_logp_two_ranks_on_one_card(tmp_path):
    """The vocab-sharded log p and its backward over two ranks sharing the
    card (``gloo``, as parallel/launch.py picks for ranks on one card)
    against the plain CE in f32 on the whole vocabulary; f32 on both sides,
    the sums in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (ranks on the card)")
    import torch_port_ranks
    from vae_lagging_encoder_tpu_torch.parallel import run_ranks

    h, w, tgt = _ce_inputs(n=300, nh=64, vocab=2000, seed=5)
    wt = np.random.RandomState(6).randn(300).astype(np.float32)
    out = run_ranks(torch_port_ranks.run_cases, 2, "cuda",
                    args=([("logp", dict(mesh_shape=(1, 2), h=h, pred=w, tgt=tgt, w=wt))],),
                    workdir=str(tmp_path), timeout=300)
    assert out[0].backend == ("gloo" if torch.cuda.device_count() < 2 else "nccl")
    hh = torch.from_numpy(h).cuda().requires_grad_(True)
    ww = torch.from_numpy(w).cuda().requires_grad_(True)
    logp, _ = ce_cuda.ce_logp_plain(hh, ww, torch.from_numpy(tgt).long().cuda(), None)
    (logp * torch.from_numpy(wt).cuda()).sum().backward()
    for o in out:
        r = o.result[0]
        t = r["tp_index"]
        np.testing.assert_allclose(r["logp"], logp.detach().cpu().numpy(), atol=1e-4)
        np.testing.assert_allclose(r["dh"], hh.grad.cpu().numpy(), atol=1e-4)
        np.testing.assert_allclose(r["dpred"], ww.grad[:, t * 1000:(t + 1) * 1000].cpu().numpy(),
                                   atol=1e-4)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_topk_small_tie_order_on_cuda():
    _need_cuda()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 3, 2000).astype(np.float32))
    x[0, 0, 100:110] = x[0, 0, 50]
    x[1, 1, :] = -np.inf
    x[2, 2, ::2] = 3.25
    for k in (1, 5, 15):
        v, i = dec_lstm._topk_small(x.cuda(), k)
        vc, ic = dec_lstm._topk_small(x, k)
        assert torch.equal(v.cpu(), vc) and torch.equal(i.cpu(), ic)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["greedy", "beam"])
def test_text_generation_on_cuda_matches_cpu(strategy):
    _need_cuda()
    dec = LSTMDecoder(50, 8, 32, 4, dropout_in=0.0, dropout_out=0.0)
    dec.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        dec.pred.mul_(300.0)  # large margins: no near-ties between f32 sums
    z = torch.randn(6, 4, generator=torch.Generator().manual_seed(2)) * 2
    run = {"greedy": lambda d, zz: d.greedy_decode(zz, 12).tolist(),
           "beam": lambda d, zz: d.beam_search_decode(zz, 3, 12)}[strategy]
    want = run(dec, z)
    assert run(dec.cuda(), z.cuda()) == want


@pytest.mark.cuda
def test_incremental_sampler_on_cuda():
    _need_cuda()
    dec = PixelCNNDecoderV2(3, img_size=(12, 12, 1), n_layers=3, filters=8)
    dec.reset_parameters(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    z = torch.randn(3, 3, generator=g)
    us = torch.rand(144, 3, 1, generator=g)
    cpu = dec.sample(z, noise=lambda p, shape: us[p])
    dec = dec.cuda()
    canvas = dec.sample(z.cuda(), noise=lambda p, shape: us[p].cuda())
    assert torch.equal(canvas.cpu(), cpu)
    _, inc = dec._incremental_pixels(z.cuda(), force_image=canvas)
    with torch.no_grad():
        dense = dec._logits(canvas, z.cuda())
    torch.testing.assert_close(inc, dense, atol=1e-5, rtol=0)


# ---------------------------------------------- shapes of chunked training
# --nsamples 40 at the Yahoo config decodes chunks of 20 samples x 32
# sentences: the LSTM kernels at 640 rows, the grad-mode CE at N = 640 x 95.
def _length_mask(T, rows, seed):
    """1 up to each row's length, then 0: masks ending at different steps."""
    lens = np.random.RandomState(seed).randint(1, T + 1, rows)
    return torch.from_numpy((np.arange(T)[:, None] < lens[None, :]).astype(np.float32))


def _mask(kind, T, rows, g, seed):
    """``holes``: each step masked with probability 0.2, so a masked step
    may come before an unmasked one (the carries kept across it, the
    backward's (1 - m) dh term then read by a product); ``lengths``:
    ``_length_mask``."""
    if kind == "holes":
        return (torch.rand(T, rows, generator=g) > 0.2).float()
    return _length_mask(T, rows, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", ["holes", "lengths"])
@pytest.mark.parametrize("rows", [640, 600])
@pytest.mark.parametrize("save_residuals", [False, True])
@pytest.mark.parametrize("wh_dtype", [torch.float32, torch.bfloat16])
def test_lstm_kernels_at_640_rows_on_cuda(wh_dtype, save_residuals, rows, mask_kind):
    """Both forwards and the backward sweep at 640 rows (and a ragged 600:
    a short second row group), H 1024, with random holes in the masks and
    with masks ending at different steps (T 12 here; the tolerances of the
    tests above at H 200-256). With bf16 wh these are the wide-row
    kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator().manual_seed(21 + rows)
    T, B, H = 12, rows, 1024
    xw = torch.randn(T, B, 4 * H, generator=g).cuda()
    mask = _mask(mask_kind, T, B, g, rows).cuda()
    wh = (torch.rand(H, 4 * H, generator=g) * 2 - 1).div(H ** 0.5).to(wh_dtype).cuda()
    h0, c0 = ((0.1 * torch.randn(B, H, generator=g)).cuda() for _ in range(2))
    key = _launch_key("lstm_fwd_residuals" if save_residuals else "lstm_fwd_infer", wh_dtype)
    n = dict(build.LAUNCHES)
    got = lstm_cuda.lstm_seq(xw, mask, wh, h0, c0, save_residuals)
    ref = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, save_residuals)
    torch.cuda.synchronize()
    assert build.LAUNCHES[key] == n[key] + 1
    tol = 1e-5 if wh_dtype == torch.float32 else 2e-3
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=tol, rtol=0)
    if not save_residuals:
        return
    _, cs, gates, _, _ = ref
    c_prev = torch.cat([c0[None], cs[:-1]])
    dhs = (0.1 * torch.randn(T, B, H, generator=g)).cuda()
    dhT, dcT = ((0.1 * torch.randn(B, H, generator=g)).cuda() for _ in range(2))
    args = (gates, mask, wh, c_prev, dhs, dhT, dcT)
    got = lstm_cuda.lstm_bwd(*args)
    ref = lstm_cuda.lstm_bwd_plain(*args)
    torch.cuda.synchronize()
    bwd_key = _launch_key("lstm_bwd", wh_dtype)
    assert build.LAUNCHES[bwd_key] == n[bwd_key] + 1
    tol = 1e-5 if wh_dtype == torch.float32 else 1e-3
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", ["holes", "lengths"])
def test_lstm_bwd_at_2112_rows_on_cuda(mask_kind):
    """The wide backward at 2112 rows, H 1024: more m-tiles a row group (17
    on 132 SMs, 33 on 114) than receive slots (8), so a slot is written
    again within a step once the other block's epilogue has read it;
    against the plain version with the backward's bf16 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    T, B, H = 6, 2112, 1024
    plan = lstm_cuda.bwd_plan(B, H, torch.cuda.get_device_properties(0).multi_processor_count)
    assert isinstance(plan, lstm_cuda.WidePlan) and plan.recv_slots < plan.m_tiles
    g = torch.Generator().manual_seed(41)
    xw = torch.randn(T, B, 4 * H, generator=g).cuda()
    mask = _mask(mask_kind, T, B, g, 41).cuda()
    wh = (torch.rand(H, 4 * H, generator=g) * 2 - 1).div(H ** 0.5).bfloat16().cuda()
    h0, c0 = ((0.1 * torch.randn(B, H, generator=g)).cuda() for _ in range(2))
    _, cs, gates, _, _ = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, True)
    dhs = (0.1 * torch.randn(T, B, H, generator=g)).cuda()
    dhT, dcT = ((0.1 * torch.randn(B, H, generator=g)).cuda() for _ in range(2))
    args = (gates, mask, wh, torch.cat([c0[None], cs[:-1]]), dhs, dhT, dcT)
    n = build.LAUNCHES["lstm_bwd"]
    got = lstm_cuda.lstm_bwd(*args)
    ref = lstm_cuda.lstm_bwd_plain(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["lstm_bwd"] == n + 1
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_lstm_seq_fn_gradient_at_640_rows_on_cuda():
    """``LSTMSeqFn``'s gradient at 640 rows, H 1024, bf16 wh (the wide-row
    forward and backward kernels, then dWh = h_prev^T da) against the same
    function computed by the plain versions on the card. dxw, dh0, dc0: the
    backward's bf16 tolerance; dWh (bf16) sums 12 x 640 products of da: one
    bf16 step of its largest entry, plus what flipped da roundings add."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator().manual_seed(31)
    T, B, H = 12, 640, 1024
    xw = torch.randn(T, B, 4 * H, generator=g).cuda()
    mask = _length_mask(T, B, 31).cuda()
    wh = (torch.rand(H, 4 * H, generator=g) * 2 - 1).div(H ** 0.5).bfloat16().cuda()
    h0, c0 = ((0.1 * torch.randn(B, H, generator=g)).cuda() for _ in range(2))
    dhs = (0.1 * torch.randn(T, B, H, generator=g)).cuda()
    leaves = [a.clone().requires_grad_() for a in (xw, wh, h0, c0)]
    n = dict(build.LAUNCHES)
    with torch.enable_grad():
        hs, _, _ = lstm_cuda.LSTMSeqFn.apply(leaves[0], mask, leaves[1], leaves[2], leaves[3])
        got = torch.autograd.grad(hs, leaves, dhs)
    torch.cuda.synchronize()
    assert build.LAUNCHES["lstm_fwd_residuals"] == n["lstm_fwd_residuals"] + 1
    assert build.LAUNCHES["lstm_bwd"] == n["lstm_bwd"] + 1
    hs_r, cs, gates, _, _ = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, True)
    c_prev = torch.cat([c0[None], cs[:-1]])
    da, dh0, dc0 = lstm_cuda.lstm_bwd_plain(gates, mask, wh, c_prev, dhs, torch.zeros_like(h0),
                                            torch.zeros_like(c0))
    h_prev = torch.cat([h0[None], hs_r[:-1]])
    dwh = (h_prev.reshape(-1, H).T @ da.reshape(-1, 4 * H)).bfloat16()
    for a, b in zip((got[0], got[2], got[3]), (da, dh0, dc0)):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=0)
    assert got[1].dtype == torch.bfloat16
    d = (got[1].float() - dwh.float()).abs().max()
    assert d <= 2.0 ** -7 * dwh.float().abs().max() + 1e-2, float(d)


@pytest.mark.cuda
def test_ce_train_kernel_at_n60800_on_cuda():
    """The grad-mode CE at N 60800, nh 1024, V 20004 (bf16 operands, the
    2.4 GB bf16 spill) against its plain version: logp and lse within 1e-3,
    the spill within one bf16 step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator().manual_seed(22)
    N, nh, V = 60800, 1024, 20004
    h = torch.tanh(torch.randn(N, nh, generator=g)).cuda()
    w = torch.empty(nh, V).uniform_(-0.05, 0.05, generator=g).cuda()
    tgt = torch.randint(0, V, (N,), generator=g).cuda()
    n = build.LAUNCHES["ce_fwd_train"]
    logp, lse, spill = ce_cuda.ce_forward(h, w, tgt, torch.bfloat16, save_logits=True)
    rlogp, rlse, rspill = ce_cuda.ce_logp_plain(h, w, tgt, torch.bfloat16, save_logits=True)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ce_fwd_train"] == n + 1
    torch.testing.assert_close(logp, rlogp, atol=1e-3, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)
    d = (spill.float() - rspill.float()).abs()
    assert bool((d <= 2.0 ** -7 * rspill.float().abs() + 1e-5).all())


def _ce_split_plan(monkeypatch, n, nh, vocab, clusters):
    """The card's bf16 CE plans taken with ``clusters`` clusters (at most the
    card's), under which a cluster's segment boundary splits a row group
    mid-vocab at h [n, nh], W [nh, vocab]."""
    plan = ce_cuda.ce_plan(n, nh, vocab, clusters)
    assert any(len(plan.merge_order(rg)) > 1 for rg in range(plan.row_groups))
    assert clusters <= ce_cuda.ce_clusters(torch.device("cuda", 0), plan.smem_bytes)
    monkeypatch.setattr(ce_cuda, "ce_clusters", lambda device, smem_bytes: clusters)
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("save", [False, True])
def test_ce_segment_splitting_a_row_tile_on_cuda(save, monkeypatch):
    """With 7 clusters at N 300 (2 row groups x 6 vocab tiles, 1 or 2 units
    a cluster), the row groups are split between clusters mid-vocab: both
    modes against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    h, w, tgt = (torch.from_numpy(a).cuda() for a in _ce_inputs(n=300, nh=72, vocab=1300, seed=6))
    _ce_split_plan(monkeypatch, 300, 72, 1300, 7)
    got = ce_cuda.ce_forward(h, w, tgt, torch.bfloat16, save_logits=save)
    ref = ce_cuda.ce_logp_plain(h, w, tgt, torch.bfloat16, save_logits=save)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], ref[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=1e-4, rtol=0)
    if save:
        d = (got[2].float() - ref[2].float()).abs()
        assert bool((d <= 2.0 ** -7 * ref[2].float().abs() + 1e-5).all())


@pytest.mark.cuda
@pytest.mark.parametrize("save", [False, True])
def test_ce_kernel_bits_equal_across_calls_on_cuda(save):
    """Two calls at the training shape (N 3040, the card's own plan) give
    the same bits in every output: the partials are merged in one order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    h, w, tgt = (torch.from_numpy(a).cuda() for a in _ce_inputs(n=3040, nh=1024, vocab=20004,
                                                                seed=7))
    a = ce_cuda.ce_forward(h, w, tgt, torch.bfloat16, save_logits=save)
    b = ce_cuda.ce_forward(h, w, tgt, torch.bfloat16, save_logits=save)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_ce_bwd_on_a_split_plans_spill_on_cuda(monkeypatch):
    """``ce_bwd`` on the residuals of a grad-mode forward whose row groups
    are split between clusters, against ``ce_backward_plain`` on the same
    residuals, within the tensor cores' accumulation bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    n, nh, vocab = 300, 72, 1300
    h, w, tgt = (torch.from_numpy(a).cuda() for a in _ce_inputs(n, nh, vocab, seed=9))
    g = torch.randn(n, generator=torch.Generator().manual_seed(9)).cuda()
    _ce_split_plan(monkeypatch, n, nh, vocab, 7)
    (_, lse, spill), operands = ce_cuda._ce_forward(h, w, tgt, torch.bfloat16, True)
    args = (h, w, tgt, lse, spill, g)
    got = ce_cuda.ce_backward(*args, torch.bfloat16, operands=operands)
    ref = ce_cuda.ce_backward_plain(*args, torch.bfloat16)
    torch.cuda.synchronize()
    plan = ce_cuda.ce_bwd_plan(n, nh, vocab, torch.cuda.get_device_properties(0)
                               .multi_processor_count)
    for a, r, k in zip(got, ref, (plan.Vp, n)):
        torch.testing.assert_close(a, r, atol=_acc_bound(r, k), rtol=0)


@pytest.mark.cuda
def test_ce_plan_beyond_the_cards_clusters_raises_on_cuda(monkeypatch):
    """A plan of one cluster more than the card holds at once is refused by
    the kernel (no launch, no count), and a card without a cluster has no
    plan: both raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    h, w, tgt = (torch.from_numpy(a).cuda() for a in _ce_inputs(n=3040, nh=64, vocab=20004,
                                                                seed=3))
    have = ce_cuda.ce_clusters(torch.device("cuda", 0), ce_cuda.CEPlan(3040, 64, 20004, 1)
                               .smem_bytes)
    assert ce_cuda.ce_plan(3040, 64, 20004, have + 1).clusters == have + 1
    n = build.LAUNCHES["ce_fwd"]
    for clusters, err in ((have + 1, RuntimeError), (0, ValueError)):
        monkeypatch.setattr(ce_cuda, "ce_clusters", lambda device, smem_bytes: clusters)
        with pytest.raises(err):
            ce_cuda.ce_forward(h, w, tgt, torch.bfloat16)
    assert build.LAUNCHES["ce_fwd"] == n


def _ce_bwd_case(n, nh, vocab, seed):
    """The grad-mode forward's residuals and operands on the card, targets at
    0 and V - 1, zeros in g (masked tokens)."""
    h, w, tgt = (torch.from_numpy(a).cuda() for a in _ce_inputs(n, nh, vocab, seed))
    tgt[0], tgt[-1] = 0, vocab - 1
    g = torch.randn(n, generator=torch.Generator().manual_seed(seed)).cuda()
    g[::5] = 0.0
    (_, lse, spill), operands = ce_cuda._ce_forward(h, w, tgt, torch.bfloat16, True)
    return (h, w, tgt, lse, spill, g), operands


def _acc_bound(ref, k):
    """The tensor cores' f32 accumulation against the plain f32 sums: at
    most one unit in the last place of the largest value a k16 step
    (chip_smoke.py's ce_bwd tolerance), plus the plain side's own rounding."""
    return (k / 16) * 2.0 ** -23 * float(ref.abs().max()) + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n,nh,vocab", [(70, 40, 1100), (70, 41, 1101), (3040, 1024, 20004)])
def test_ce_bwd_kernel_matches_plain_on_cuda(n, nh, vocab):
    """``csrc/ce_bwd.cu`` against ``ce_backward_plain`` on the same
    residuals: V not a multiple of the 256-wide tiles, nh 40 below one box;
    odd nh and V (h padded to 48 columns, the stores of single floats); the
    training shape (dh's K split over 4 blocks). Two calls give the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    args, operands = _ce_bwd_case(n, nh, vocab, seed=n)
    launches = build.LAUNCHES["ce_bwd"]
    got = ce_cuda.ce_backward(*args, torch.bfloat16, operands=operands)
    again = ce_cuda.ce_backward(*args, torch.bfloat16, operands=operands)
    ref = ce_cuda.ce_backward_plain(*args, torch.bfloat16)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ce_bwd"] == launches + 2
    plan = ce_cuda.ce_bwd_plan(n, nh, vocab, torch.cuda.get_device_properties(0)
                               .multi_processor_count)
    for a, r, k in zip(got, ref, (plan.Vp, n)):
        assert a.shape == r.shape and a.dtype == torch.float32
        torch.testing.assert_close(a, r, atol=_acc_bound(r, k), rtol=0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_fused_ce_fn_backward_on_cuda_matches_cpu():
    """``FusedCEFn``'s dh and dW on the card (the grad-mode forward and the
    backward kernel, one launch each) against the CPU's plain versions.
    The two forwards' spills may round a logit to neighbouring bf16 values,
    which moves a softmax entry by a part in 2^8 of itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    h, w, tgt = _ce_inputs(n=300, nh=64, vocab=1300, seed=8)
    g = torch.randn(300, generator=torch.Generator().manual_seed(8))
    grads = []
    for dev in ("cuda", "cpu"):
        th, tw = (torch.from_numpy(a).to(dev).requires_grad_() for a in (h, w))
        n = dict(build.LAUNCHES)
        logp = ce_cuda.FusedCEFn.apply(th, tw, torch.from_numpy(tgt).to(dev), torch.bfloat16)
        logp.backward(g.to(dev))
        launched = {k: build.LAUNCHES[k] - n[k] for k in n}
        want = 1 if dev == "cuda" else 0
        assert launched["ce_fwd_train"] == launched["ce_bwd"] == want, launched
        grads.append((th.grad.cpu(), tw.grad.cpu()))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


@pytest.mark.cuda
def test_ce_bwd_extra_memory_on_cuda():
    """At N 3040 the backward allocates, beyond the dh and dW it returns, one
    bf16 [N, Vp] d and the split-K partials (the caching allocator may hand
    out up to 1 MiB more than asked for a block); no f32 [N, V] tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    n, nh, vocab = 3040, 1024, 20004
    args, operands = _ce_bwd_case(n, nh, vocab, seed=4)
    plan = ce_cuda.ce_bwd_plan(n, nh, vocab, torch.cuda.get_device_properties(0)
                               .multi_processor_count)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    dh, dw = ce_cuda.ce_backward(*args, torch.bfloat16, operands=operands)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before - 4 * (dh.numel() + dw.numel())
    assert extra <= plan.d_bytes + plan.part_bytes + 4 * 2 ** 20, extra
    assert extra < 4 * n * vocab  # less than one f32 [N, V] tensor


@pytest.mark.cuda
def test_ce_bwd_refuses_what_the_kernel_does_not_take_on_cuda():
    """An f32 spill with bf16 operands, a spill whose rows are not 16-byte
    aligned (a contiguous [N, 1100] copy), an operand of another layout,
    and no operands at all, raise; f32 operands take the plain f32
    products (no launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    (h, w, tgt, lse, spill, g), (hb, wt) = _ce_bwd_case(70, 40, 1100, seed=3)
    with pytest.raises(ValueError):
        ce_cuda.ce_backward(h, w, tgt, lse, spill.float(), g, torch.bfloat16, operands=(hb, wt))
    with pytest.raises(ValueError):
        ce_cuda.ce_backward(h, w, tgt, lse, spill.contiguous(), g, torch.bfloat16,
                            operands=(hb, wt))
    with pytest.raises(ValueError):
        ce_cuda.ce_backward(h, w, tgt, lse, spill, g, torch.bfloat16, operands=(hb, wt[:, :40]))
    with pytest.raises(ValueError, match="operands"):
        ce_cuda.ce_backward(h, w, tgt, lse, spill, g, torch.bfloat16)
    n = build.LAUNCHES["ce_bwd"]
    got = ce_cuda.ce_backward(h, w, tgt, lse, spill.float(), g, None)
    ref = ce_cuda.ce_backward_plain(h, w, tgt, lse, spill.float(), g, None)
    assert build.LAUNCHES["ce_bwd"] == n
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.cuda
def test_mid_epoch_resume_on_cuda(tmp_path):
    """A run stopped mid-epoch and resumed from its autosave on the card
    (kernel route, H 128, a 1100-word vocabulary so the fused CE runs)
    against the uninterrupted run: the same epochs, every metric and the
    best parameters within RESUME_RTOL of their scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from vae_lagging_encoder_tpu_torch.config import get_config
    from vae_lagging_encoder_tpu_torch.data import BucketedPool, MonoTextData
    from vae_lagging_encoder_tpu_torch.models import build_text_vae
    from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint
    from vae_lagging_encoder_tpu_torch.train.loop import run_training
    from vae_lagging_encoder_tpu_torch.utils.exp_utils import Logger
    from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

    rng = np.random.RandomState(0)
    words = [f"w{i}" for i in range(1096)]
    for split, n in (("train", 96), ("valid", 16), ("test", 16)):
        lines = [" ".join(words[j] for j in rng.randint(0, 1096, rng.randint(5, 14)))
                 for _ in range(n)]
        if split == "train":
            lines += [" ".join(words[i:i + 137]) for i in range(0, 1096, 137)]
        (tmp_path / f"{split}.txt").write_text("".join(f"1\t{l}\n" for l in lines))

    def run(name, stop=None, resume=None):
        cfg = get_config("yahoo", ni=32, enc_nh=128, dec_nh=128, nz=4, batch_size=16,
                         epochs=2, aggressive=True, warm_up=1, burn_max_iters=6, burn_window=2,
                         iw_nsamples=4, iw_batch=2, autosave_niter=3,
                         train_data=str(tmp_path / "train.txt"),
                         val_data=str(tmp_path / "valid.txt"),
                         test_data=str(tmp_path / "test.txt"),
                         save_path=str(tmp_path / f"{name}.ckpt"))
        train = MonoTextData(cfg.train_data, label=True)
        pool = lambda f: BucketedPool(MonoTextData(f, label=True, vocab=train.vocab)
                                      .create_data_batch(cfg.batch_size, (16, 160)), "cuda")
        vae = build_text_vae(cfg, len(train.vocab), generator=torch.Generator().manual_seed(1))
        assert vae.dec.fused_ce
        extra = None
        if resume:
            params, extra = load_checkpoint(resume)
            vae.load_state_dict(from_jax_params(params))
        return run_training(cfg, vae, pool(cfg.train_data), pool(cfg.val_data),
                            pool(cfg.test_data), Logger(), resume_state=extra,
                            _stop_after_steps=stop)

    full = run("full")
    # 7 batches, segments of 3 (the autosave cadence): autosaves at steps 3, 6,
    # then 10 (epoch 1, after its first segment), where the run stops
    r = run("run", stop=10)
    assert r["interrupted"] and load_checkpoint(r["autosave_path"])[1]["mid_epoch"]["epoch"] == 1
    resumed = run("run", resume=r["autosave_path"])
    assert [h["epoch"] for h in resumed["history"]] == [1]
    for k, v in full["history"][1].items():
        assert v == pytest.approx(resumed["history"][0][k], rel=RESUME_RTOL, abs=0), k
    for k in ("elbo_loss", "iw_nll", "kl", "mi"):
        assert resumed[k] == pytest.approx(full[k], rel=RESUME_RTOL, abs=0), k
    a = from_jax_params(load_checkpoint(str(tmp_path / "full.ckpt"))[0])
    b = from_jax_params(load_checkpoint(str(tmp_path / "run.ckpt"))[0])
    for k in a:
        assert float((a[k] - b[k]).abs().max()) <= RESUME_RTOL * float(a[k].abs().max()), k


# the card's run of a step is deterministic on this path (see chip_smoke.py
# phase 7a, which measures the same difference at the Yahoo width)
RESUME_RTOL = 0.0


def _graph_corpus(tmp_path):
    """96 short sentences and 8 of 137 words over 1096 words: two bucket
    shapes, a vocabulary of 1100, so the fused CE takes its kernel."""
    rng = np.random.RandomState(0)
    words = [f"w{i}" for i in range(1096)]
    lines = [" ".join(words[j] for j in rng.randint(0, 1096, rng.randint(5, 14)))
             for _ in range(96)] + [" ".join(words[i:i + 137]) for i in range(0, 1096, 137)]
    (tmp_path / "train.txt").write_text("".join(f"1\t{l}\n" for l in lines))
    return str(tmp_path / "train.txt")


def _graph_epoch(kind, tmp_path, graphs, aggressive, unroll=1):
    """One epoch of ``make_train_epoch`` on the card at a small width
    (kernel route, H 128; or the image model at narrow widths), graphed or
    eager, from the same seeded weights, order and noise: the model, the
    epoch's outputs, ``epoch_fn.steps`` and the kernel launches."""
    from vae_lagging_encoder_tpu_torch.config import get_config
    from vae_lagging_encoder_tpu_torch.data import BucketedPool, ImagePool, MonoTextData
    from vae_lagging_encoder_tpu_torch.models import build_image_vae, build_text_vae
    from vae_lagging_encoder_tpu_torch.train.epoch import (GeneratorNoise, make_image_loss_fn,
                                                           make_train_epoch)

    over = dict(burn_max_iters=6, burn_window=2, warm_up=1, kl_start=0.1, loop_unroll=unroll)
    gen = torch.Generator().manual_seed(1)
    if kind == "text":
        cfg = get_config("yahoo", ni=32, enc_nh=128, dec_nh=128, nz=4, batch_size=16,
                         dec_dropout_in=0.3, dec_dropout_out=0.3, **over)
        data = MonoTextData(_graph_corpus(tmp_path), label=True)
        pool = BucketedPool(data.create_data_batch(cfg.batch_size, (16, 160)), "cuda")
        vae, loss_fn = build_text_vae(cfg, len(data.vocab), "cuda", generator=gen), None
        assert vae.dec.fused_ce
    elif kind == "image":
        cfg = get_config("omniglot", nz=4, enc_layers=(8, 8), dec_layers=2, dec_filters=8,
                         batch_size=10, **over)
        imgs = (np.random.RandomState(2).rand(70, 28, 28, 1) ** 3).astype(np.float32)
        pool = ImagePool(imgs, cfg.batch_size, "cuda")
        vae = build_image_vae(cfg, "cuda", generator=gen)
        loss_fn = make_image_loss_fn(vae, nsamples=1, train=True)
    else:  # the published model: batch norm in the graph, a last batch of 3
        cfg = get_config("omniglot", image_arch="published", nz=4, enc_layers=(8, 8),
                         enc_head=16, dec_kernels=(5, 3, 3, 3, 3), dec_hidden=8,
                         dec_bottleneck=4, latent_maps=2, batch_size=10, **over)
        imgs = (np.random.RandomState(2).rand(73, 28, 28, 1) ** 3).astype(np.float32)
        pool = ImagePool(imgs, cfg.batch_size, "cuda", pad=False)
        vae = build_image_vae(cfg, "cuda", generator=gen)
        loss_fn = make_image_loss_fn(vae, nsamples=1, train=True)
    build.reset_launches()
    epoch_fn, opt_init = make_train_epoch(vae, pool, cfg, loss_fn=loss_fn, graphs=graphs)
    order = np.random.RandomState(3).permutation(pool.num_batches)
    out = epoch_fn(opt_init(), GeneratorNoise(4, "cuda"), np.float32(0.1), cfg.lr, order,
                   aggressive, seg=3)
    torch.cuda.synchronize()
    return vae, out, epoch_fn.steps, dict(build.LAUNCHES), dict(build.GRAPHS), len(order)


@pytest.mark.cuda
@pytest.mark.parametrize("aggressive", [False, True])
@pytest.mark.parametrize("kind", ["text", "image", "published"])
def test_graphed_epoch_equals_eager_on_cuda(kind, aggressive, tmp_path):
    """Plain steps, aggressive outer steps and sub-iterations replayed from
    captured CUDA graphs against the same steps run eagerly: parameters,
    buffers (the published model's batch-norm statistics), optimizer state
    and sums bit for bit; the replays launch the kernels the eager steps
    launch (``LAUNCHES`` counted per replay)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from vae_lagging_encoder_tpu_torch.train.graphs import _leaves

    g_vae, g_out, g_steps, g_launch, g_graphs, n = _graph_epoch(kind, tmp_path, True, aggressive)
    e_vae, e_out, e_steps, e_launch, e_graphs, _ = _graph_epoch(kind, tmp_path, False,
                                                               aggressive)
    assert g_steps.off is None and e_steps.off
    for (k, p), (_, q) in zip(g_vae.state_dict().items(), e_vae.state_dict().items()):
        assert torch.equal(p, q), k
    if kind == "published":
        assert int(g_vae.state_dict()["dec.bn_a.num_batches_tracked"]) == n + g_out[3]
    for (path, a), (_, b) in zip(_leaves(g_out[0]), _leaves(e_out[0])):
        assert torch.equal(a, b), path
    assert g_out[2].tolist() == e_out[2].tolist() and g_out[1] == e_out[1]
    assert g_out[3] == e_out[3]
    steps = n + g_out[3]
    stats = g_steps.stats
    assert stats["eager_steps"] + stats["graph_steps"] == steps
    assert g_graphs["replays"] == stats["graph_steps"] > 0 and g_graphs["captured"] > 0
    assert e_graphs == {"captured": 0, "replays": 0}
    assert g_launch == e_launch
    if kind == "text":  # per forward+backward: 2 residual forwards, 2 backwards, 1 CE
        # (f32 at H 128: the f32-wh LSTM kernels)
        per_step = {"lstm_fwd_residuals_f32": 2, "lstm_bwd_f32": 2, "ce_fwd_train": 1}
        assert {k: g_launch[k] for k in per_step} == {k: v * steps for k, v in per_step.items()}


@pytest.mark.cuda
def test_spans_share_the_trace_clock_on_cuda(tmp_path):
    """The recorder (utils/profiling.py) on a tiny graphed aggressive epoch:
    on under a session of CUDA activity alone (as port_bench/tracing.py
    opens it); in one CPU+CUDA trace every span's start and end lie within
    50 us of its annotation event's; the device spans inside a
    capture record no event, those of eager steps and every replay do;
    ``device_reads`` counts the reads; ``LAUNCHES``, ``GRAPHS`` and the
    epoch's answers are those of the same epoch with tracing off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import collections
    import json

    from torch.profiler import ProfilerActivity, profile

    from vae_lagging_encoder_tpu_torch.utils import profiling

    profiling.take()
    x = torch.ones(64, device="cuda")  # device spans need a CUDA context made before them
    with profile(activities=[ProfilerActivity.CUDA]):
        assert torch.autograd.profiler._is_profiler_enabled
        with profiling.span("probe", device=True):
            x.sum()
    (probe,) = profiling.take()["spans"]
    assert probe["device_ms"] is not None and probe["device_ms"] >= 0
    # a process's first annotation may hold ~1 ms of one-time set-up
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("warm"):
            pass
    profiling.take()

    off = _graph_epoch("text", tmp_path, True, True)
    assert profiling.take()["spans"] == []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        on = _graph_epoch("text", tmp_path, True, True)
    state = profiling.take()
    assert on[3] == off[3] and on[4] == off[4]  # LAUNCHES, GRAPHS
    assert on[1][2].tolist() == off[1][2].tolist() and on[1][3] == off[1][3]
    for (k, p), (_, q) in zip(on[0].named_parameters(), off[0].named_parameters()):
        assert torch.equal(p, q), k

    spans = state["spans"]
    assert spans and state["counters"]["spans_dropped"] == 0
    names = [s["name"] for s in spans]
    reads = names.count("plateau_read") + names.count("segment_read")
    assert reads > 0 and state["counters"]["device_reads"] == reads

    def path_of(i):
        while spans[i]["name"] != "step":
            i = spans[i]["parent"]
        return spans[i]["attrs"]["path"]

    paths = collections.Counter()
    for i, s in enumerate(spans):
        if s["name"] in ("lstm.input_proj", "lstm.recurrence", "ce"):
            path = path_of(i)
            paths[path] += 1
            assert (s["device_ms"] is None) == (path == "capture"), (s["name"], path)
        if s["name"] == "replay":
            assert s["device_ms"] is not None and path_of(i) in ("capture", "replay")
    assert paths["capture"] > 0 and paths["eager"] > 0 and "replay" not in paths

    trace_path = tmp_path / "spans.trace.json"
    prof.export_chrome_trace(str(trace_path))
    trace = json.loads(trace_path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = collections.defaultdict(list)
    for e in trace["traceEvents"]:
        if (e.get("ph") == "X" and e.get("cat") in ("user_annotation", "cpu_op")
                and e["name"] in names):
            events[e["name"]].append(e)
    gaps = []  # (|gap| us, gap, side, name, position in the session)
    t0 = min(s["start_ns"] for s in spans)
    for name in set(names):
        got = sorted((s for s in spans if s["name"] == name), key=lambda s: s["start_ns"])
        evs = sorted(events[name], key=lambda e: e["ts"])
        assert len(evs) == len(got), name
        for s, e in zip(got, evs):
            for side, gap in (("start", (s["start_ns"] - base) / 1e3 - e["ts"]),
                              ("end", (s["end_ns"] - base) / 1e3 - (e["ts"] + e["dur"]))):
                gaps.append((abs(gap), gap, side, name, (s["start_ns"] - t0) / 1e6))
    gaps.sort()
    print(f"spans: {len(spans)}; gaps to the trace's clock (us): median {gaps[len(gaps) // 2][0]:.1f}, "
          f"p95 {gaps[int(0.95 * len(gaps))][0]:.1f}, largest {gaps[-1][0]:.1f}; the largest: "
          + "; ".join(f"{g:.1f} {side} {name} at {ms:.1f} ms" for _, g, side, name, ms in gaps[-8:]))
    assert gaps[-1][0] < 50.0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["text", "image"])
def test_eager_epoch_is_deterministic_on_cuda(kind, tmp_path):
    """Two eager runs of one epoch from the same state are equal bit for bit
    (the image convs' backward takes cuDNN's deterministic algorithms,
    ops/conv.py), so a graphed run can be held against an eager one
    exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    a, b = (_graph_epoch(kind, tmp_path, False, False)[0] for _ in range(2))
    for (k, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), k


@pytest.mark.cuda
def test_replays_count_launches_on_cuda(tmp_path):
    """N replays of the plain step's graph add N times the eager step's
    kernel launches; ``--loop_unroll 3`` is accepted and changes nothing:
    one replay a step, the same launches and parameters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    runs = {u: _graph_epoch("text", tmp_path, True, False, unroll=u) for u in (1, 3)}
    (v1, o1, s1, l1, g1, n), (v3, o3, s3, l3, g3, _) = runs[1], runs[3]
    assert g1["replays"] == s1.stats["graph_steps"] == n - s1.stats["eager_steps"]
    assert l1["lstm_bwd_f32"] == 2 * n and l1["ce_fwd_train"] == n  # f32 wh at H 128
    assert l3 == l1 and g3 == g1
    for (k, p), (_, q) in zip(v1.named_parameters(), v3.named_parameters()):
        assert torch.equal(p, q), k


@pytest.mark.cuda
def test_capture_failure_raises_on_cuda(tmp_path):
    """A step that reads the device from the host cannot be captured: the
    epoch raises at the capture (after the eager warm-up) instead of
    running eagerly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from vae_lagging_encoder_tpu_torch.config import get_config
    from vae_lagging_encoder_tpu_torch.data import ImagePool
    from vae_lagging_encoder_tpu_torch.models import build_image_vae
    from vae_lagging_encoder_tpu_torch.train.epoch import (GeneratorNoise, make_image_loss_fn,
                                                           make_train_epoch)

    cfg = get_config("omniglot", nz=4, enc_layers=(8, 8), dec_layers=2, dec_filters=8,
                     batch_size=10)
    pool = ImagePool((np.random.RandomState(2).rand(30, 28, 28, 1)).astype(np.float32),
                     cfg.batch_size, "cuda")
    vae = build_image_vae(cfg, "cuda", generator=torch.Generator().manual_seed(1))
    loss_fn = make_image_loss_fn(vae, nsamples=1, train=True)

    def syncing_loss(batch, draw, kl_weight):
        mean_loss, aux = loss_fn(batch, draw, kl_weight)
        float(mean_loss)  # a host read inside the step
        return mean_loss, aux

    epoch_fn, opt_init = make_train_epoch(vae, pool, cfg, loss_fn=syncing_loss)
    with pytest.raises(RuntimeError):
        epoch_fn(opt_init(), GeneratorNoise(4, "cuda"), np.float32(0.1), cfg.lr, np.arange(3),
                 False)
    assert epoch_fn.steps.stats["eager_steps"] == 1 and epoch_fn.steps.stats["graph_steps"] == 0


# ------------------------------------------- narrow-row LSTM kernels
# Below WIDE_MIN_ROWS the bf16 forwards and the backward run the narrow-row
# kernels (lstm_cuda.NarrowPlan) wherever a plan fits: the training batch
# (32), a short last batch (20), a partial m-tile (37), four m-tiles (64),
# and the row count below each threshold (95 for the backward, 127 for the
# forwards), where the wrapper's plan may be the mma.sync one.
NARROW_ROWS = [20, 32, 37, 64, "threshold"]


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", ["holes", "lengths"])
@pytest.mark.parametrize("rows", NARROW_ROWS)
def test_lstm_narrow_kernels_match_plain_on_cuda(rows, mask_kind):
    """Both forwards and the backward sweep at H 1024, T 24, bf16 wh, under
    the plan the wrappers pick, against the plain versions with chip_smoke's
    tolerances (forward 2e-3, backward 5e-4: a flipped bf16 rounding of an
    operand carried through the steps), and each twice: equal bits (every
    sum in a fixed order, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    T, H = 24, 1024
    g = torch.Generator().manual_seed(51 + (rows if isinstance(rows, int) else 0))
    for kind, key in (("infer", "lstm_fwd_infer"), ("resid", "lstm_fwd_residuals"),
                      ("bwd", "lstm_bwd")):
        k = "bwd" if kind == "bwd" else "infer"
        B = lstm_cuda.WIDE_MIN_ROWS[k] - 1 if rows == "threshold" else rows
        xw = torch.randn(T, B, 4 * H, generator=g).cuda()
        mask = _mask(mask_kind, T, B, g, B).cuda()
        wh = (torch.rand(H, 4 * H, generator=g) * 2 - 1).div(H ** 0.5).bfloat16().cuda()
        h0, c0 = ((0.1 * torch.randn(B, H, generator=g)).cuda() for _ in range(2))
        plan = (lstm_cuda.bwd_plan(B, H, nsm) if k == "bwd"
                else lstm_cuda.infer_plan(B, H, nsm, kind == "resid"))
        if B <= 32:
            assert isinstance(plan, lstm_cuda.NarrowPlan), plan
        if kind == "bwd":
            _, cs, gates, _, _ = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, True)
            dhs = (0.1 * torch.randn(T, B, H, generator=g)).cuda()
            dhT, dcT = ((0.1 * torch.randn(B, H, generator=g)).cuda() for _ in range(2))
            args = (gates, mask, wh, torch.cat([c0[None], cs[:-1]]), dhs, dhT, dcT)
            run, ref, tol = (lambda: lstm_cuda.lstm_bwd(*args), lstm_cuda.lstm_bwd_plain(*args),
                             5e-4)
        else:
            res = kind == "resid"
            run = lambda: lstm_cuda.lstm_seq(xw, mask, wh, h0, c0, res)
            ref, tol = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, res), 2e-3
        n = build.LAUNCHES[key]
        got, again = run(), run()
        torch.cuda.synchronize()
        assert build.LAUNCHES[key] == n + 2
        for a, a2, b in zip(got, again, ref):
            torch.testing.assert_close(a, b, atol=tol, rtol=0)
            assert torch.equal(a, a2), f"{kind} rows {B}: two calls differ"


@pytest.mark.cuda
def test_lstm_narrow_refuses_a_foreign_plan_on_cuda():
    """The narrow kernels check their plan: a plan with the wrong shared
    memory, cluster or warps is refused (cudaErrorInvalidValue) and raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import dataclasses
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    T, B, H = 3, 20, 256
    xw, mask = torch.zeros(T, B, 4 * H, device="cuda"), torch.ones(T, B, device="cuda")
    wh = torch.zeros(H, 4 * H, device="cuda", dtype=torch.bfloat16)
    h0 = c0 = torch.zeros(B, H, device="cuda")
    plan = lstm_cuda.narrow_plan("infer", B, H, nsm)
    for bad in (dataclasses.replace(plan, cluster=3), dataclasses.replace(plan, cluster=4),
                dataclasses.replace(plan, n_sub=2), dataclasses.replace(plan, warps=plan.warps + 1)):
        with pytest.raises(RuntimeError, match="lstm_infer_narrow"):
            lstm_cuda.lstm_infer(xw, mask, wh, h0, c0, bad)
    bplan = lstm_cuda.narrow_plan("bwd", B, H, nsm)
    gates, c_prev, dhs = (torch.zeros(T, B, n * H, device="cuda") for n in (4, 1, 1))
    with pytest.raises(RuntimeError, match="lstm_bwd"):
        lstm_cuda.lstm_bwd_bf16(gates, mask, wh, c_prev, dhs, h0, c0,
                                dataclasses.replace(bplan, cluster=3))


@pytest.mark.cuda
def test_lstm_narrow_blocks_on_cuda():
    """The blocks the card holds at once in pairs of each narrow kernel
    (``narrow_blocks``, asked of the card once): whole pairs, no more than
    its SMs; where they hold H 1024's 128 blocks the wrappers run the narrow
    plan at 32 rows, else the mma.sync plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    for kind, res in (("infer", False), ("infer", True), ("bwd", False)):
        n = lstm_cuda.narrow_blocks(dev, kind, res)
        assert 0 < n <= nsm and n % 2 == 0, (kind, res, n)
        plan = (lstm_cuda.infer_plan(32, 1024, nsm, res, n) if kind == "infer"
                else lstm_cuda.bwd_plan(32, 1024, nsm, n))
        assert isinstance(plan, lstm_cuda.NarrowPlan if n >= 128 else lstm_cuda.MMAPlan), (n, plan)


# ------------------------------------------------------- the f32-wh kernels
# csrc/lstm_f32.cu (wh in f32: H <= 512 with f32 compute on the kernel
# route) at the shapes chip_smoke.py times: H 512 at the training step's 32
# rows, a short batch of 20, --nsamples 40's and the IW decoder's 640 and a
# ragged 600; H 128; the off-tile H 50; H 1024 (T 12 here). f32 on both
# sides: the order of the f32 sums differs, 1e-5 as above.
F32_SHAPES = [(512, 32), (512, 20), (512, 640), (512, 600), (128, 32), (128, 640), (50, 32),
              (50, 640), (1024, 32)]


def _f32_run(kind, H, B, T, seed):
    g = torch.Generator().manual_seed(seed)
    xw = torch.randn(T, B, 4 * H, generator=g).cuda()
    mask = _mask("holes", T, B, g, seed).cuda()
    wh = (torch.rand(H, 4 * H, generator=g) * 2 - 1).div(H ** 0.5).cuda()
    h0, c0 = ((0.1 * torch.randn(B, H, generator=g)).cuda() for _ in range(2))
    if kind != "bwd":
        res = kind == "resid"
        return (lambda: lstm_cuda.lstm_seq(xw, mask, wh, h0, c0, res),
                lambda: lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, res))
    _, cs, gates, _, _ = lstm_cuda.lstm_seq_plain(xw, mask, wh, h0, c0, True)
    dhs = (0.1 * torch.randn(T, B, H, generator=g)).cuda()
    dhT, dcT = ((0.1 * torch.randn(B, H, generator=g)).cuda() for _ in range(2))
    args = (gates, mask, wh, torch.cat([c0[None], cs[:-1]]), dhs, dhT, dcT)
    return lambda: lstm_cuda.lstm_bwd(*args), lambda: lstm_cuda.lstm_bwd_plain(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["infer", "resid", "bwd"])
@pytest.mark.parametrize("H,rows", F32_SHAPES)
def test_lstm_f32_kernels_match_plain_on_cuda(H, rows, kind):
    """Each f32 kernel under the plan the wrapper picks against its plain
    version, launched once a call, and two calls equal bit for bit (the K
    slices and the backward's halves summed in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    run, plain = _f32_run(kind, H, rows, 12, 61 + H + rows)
    key = {"infer": "lstm_fwd_infer_f32", "resid": "lstm_fwd_residuals_f32",
           "bwd": "lstm_bwd_f32"}[kind]
    n = build.LAUNCHES[key]
    got, again, ref = run(), run(), plain()
    torch.cuda.synchronize()
    assert build.LAUNCHES[key] == n + 2
    for a, a2, b in zip(got, again, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        assert torch.equal(a, a2), f"{kind} H {H} rows {rows}: two calls differ"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["infer", "resid", "bwd"])
@pytest.mark.parametrize("H,rows", [(512, 32), (512, 640)])
def test_lstm_f32_kernels_graph_replay_on_cuda(H, rows, kind):
    """A CUDA graph of one f32 kernel call replays to the eager call's
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    run, _ = _f32_run(kind, H, rows, 6, 71 + rows)
    eager = run()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()  # the plan's capacity query and the library, outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_lstm_f32_capacity_query_on_cuda():
    """``f32_blocks``: the blocks the card holds at once in pairs, at the
    most shared memory a block may take, hold every plan ``f32_plan`` makes
    for the card (H 512 on an H100: 128 blocks of 4 units); a plan past them
    is refused with cudaErrorCooperativeLaunchTooLarge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    for kind in ("infer", "bwd"):
        cap = lstm_cuda.f32_blocks(dev, kind)
        assert nsm // 2 * 2 <= cap <= nsm
        for H in (50, 128, 512, 1024):
            for rows in (32, 640):
                assert lstm_cuda.f32_plan(kind, rows, H, nsm, cap).blocks <= cap
    xw = torch.zeros(2, 32, 4 * 512, device="cuda")
    mask, wh = torch.ones(2, 32, device="cuda"), torch.zeros(512, 4 * 512, device="cuda")
    h0 = torch.zeros(32, 512, device="cuda")
    plan = lstm_cuda.f32_plan("infer", 32, 512, nsm)
    too_many = dataclasses.replace(plan, row_groups=2 + 2 * nsm // plan.unit_blocks,
                                   rows=plan.rows_per_group * (2 + 2 * nsm // plan.unit_blocks))
    xw_big = torch.zeros(2, too_many.rows, 4 * 512, device="cuda")
    with pytest.raises(RuntimeError, match="lstm_fwd_f32"):
        lstm_cuda.lstm_fwd_f32(xw_big, torch.ones(2, too_many.rows, device="cuda"), wh,
                               torch.zeros(too_many.rows, 512, device="cuda"),
                               torch.zeros(too_many.rows, 512, device="cuda"), too_many)
    lstm_cuda.lstm_fwd_f32(xw, mask, wh, h0, h0, plan)  # the plan the card holds runs
    torch.cuda.synchronize()


# ------------------------------------------------ the f32-operand CE kernel
# csrc/ce_f32.cu (operand_dtype None): f32 on both sides, only the order of
# the sums differs (one nh-long dot, one V-long logsumexp): 1e-4 as
# chip_smoke.py's f32 CE checks; the f32 spill within 1e-5 of the plain
# logits. Ragged N (129, 257: one row in the last 128-row tile), nh off the
# 32-deep K slab (36, 40, 72), V off the 128-wide tile and off 4 (1026,
# 1030: a padded W and the [:, :V] view of a [N, Vs] spill), the Yahoo width
# at the training shape's N 3040.
CE_F32_SHAPES = [(70, 40, 1100), (129, 36, 1026), (257, 36, 1030), (300, 72, 1300),
                 (3040, 1024, 20004)]


def _ce_f32_case(n, nh, vocab, seed, save):
    """The f32 kernel (twice) and its plain version on the same inputs,
    targets at 0 and V - 1."""
    h, w, tgt = (torch.from_numpy(a).cuda() for a in _ce_inputs(n, nh, vocab, seed))
    tgt[0], tgt[-1] = 0, vocab - 1
    name = "ce_fwd_train" if save else "ce_fwd"
    launches = build.LAUNCHES[name]
    got = ce_cuda.ce_forward(h, w, tgt, None, save_logits=save)
    again = ce_cuda.ce_forward(h, w, tgt, None, save_logits=save)
    ref = ce_cuda.ce_logp_plain(h, w, tgt, None, save_logits=save)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == launches + 2
    return got, again, ref


def _assert_ce_f32_close(got, ref, save, vocab):
    torch.testing.assert_close(got[0], ref[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=1e-4, rtol=0)
    if save:
        assert got[2].dtype == torch.float32 and tuple(got[2].shape) == (got[0].shape[0], vocab)
        assert got[2].stride(0) == -(-vocab // 4) * 4 and got[2].data_ptr() % 16 == 0
        torch.testing.assert_close(got[2], ref[2], atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("n,nh,vocab", CE_F32_SHAPES)
def test_ce_f32_kernel_matches_plain_on_cuda(n, nh, vocab, save):
    """``ce_f32_kernel`` under the card's own plan against its plain version
    in both modes; two calls give the same bits (the partials are merged in
    one order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    got, again, ref = _ce_f32_case(n, nh, vocab, 40 + n + save, save)
    _assert_ce_f32_close(got, ref, save, vocab)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("blocks", [5, 7])
def test_ce_f32_segments_splitting_a_row_tile_on_cuda(blocks, save, monkeypatch):
    """Under a plan of 5 or 7 blocks at N 300, V 1030 (3 row tiles x 9 vocab
    tiles) every row tile's vocab is split between lanes, and the blocks walk
    several row tiles: both modes against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    plan = ce_cuda.ce_f32_plan(300, 72, 1030, blocks)
    assert plan.lanes > 1 and any(len(plan.segments(c)) > 1 for c in range(plan.blocks))
    monkeypatch.setattr(ce_cuda, "ce_f32_blocks", lambda device: blocks)
    got, again, ref = _ce_f32_case(300, 72, 1030, 50 + blocks, save)
    _assert_ce_f32_close(got, ref, save, 1030)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_ce_f32_plan_beyond_the_cards_blocks_raises_on_cuda(monkeypatch):
    """A plan of more blocks than the card holds at once is refused by the
    kernel (no launch, no count), and a card that holds no block has no
    plan: both raise. The card's own plan is within its blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    have = ce_cuda.ce_f32_blocks(dev)
    assert 0 < have <= 2 * torch.cuda.get_device_properties(0).multi_processor_count
    assert ce_cuda.ce_f32_plan(3040, 1024, 20004, have).blocks <= have
    h, w, tgt = (torch.from_numpy(a).cuda() for a in _ce_inputs(n=3040, nh=64, vocab=20004,
                                                                seed=3))
    assert ce_cuda.ce_f32_plan(3040, 64, 20004, have + 8).blocks > have
    n = build.LAUNCHES["ce_fwd"]
    for blocks, err in ((have + 8, RuntimeError), (0, ValueError)):
        monkeypatch.setattr(ce_cuda, "ce_f32_blocks", lambda device: blocks)
        with pytest.raises(err):
            ce_cuda.ce_forward(h, w, tgt, None)
    assert build.LAUNCHES["ce_fwd"] == n
