"""Guards of the PyTorch port.

- The port (every module; the parallel modules, the evaluator re-exports
  and the native reader each alone too), what a rank started by
  ``run_ranks`` imports, and ``chip_smoke.py`` import neither JAX nor the
  JAX package.
- Entry points run on the GPU unless asked for the CPU: on a machine
  without CUDA, the default-device VAE and the CLI without ``--device cpu``
  raise, and ``python chip_smoke.py`` exits non-zero, also as a lone file.
- ``from_jax_params`` round-trips; one checkpoint loads in both packages;
  the CLI's ``--eval --device cpu`` runs on a checkpoint the JAX package
  wrote; without ``--eval`` it trains, writes a best checkpoint with its
  optimizer state that the JAX package reads, and ``--resume`` continues
  from it exactly as the uninterrupted run went on.
- The same for the image model, whose parameter and Adam-moment trees hold
  lists: a checkpoint either package writes loads in the other, and
  ``cli.image --device cpu`` trains at tiny width on an ``.npz``, resumes
  exactly and evaluates its best checkpoint.
- Generation: ``cli.text`` and ``cli.image`` with ``--sample_from_prior``
  or ``--reconstruct``, and ``cli.toy``, raise without a card unless given
  ``--device cpu``; with it they run on a checkpoint the JAX package wrote.
"""
import ast
import json
import os
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from vae_lagging_encoder_tpu.models import build_image_vae as jax_build_image
from vae_lagging_encoder_tpu.models import build_text_vae as jax_build
from vae_lagging_encoder_tpu.config import get_config as jax_get_config
from vae_lagging_encoder_tpu.train import optim as jax_optim
from vae_lagging_encoder_tpu.train.checkpoint import load_checkpoint as jax_load
from vae_lagging_encoder_tpu.train.checkpoint import save_checkpoint as jax_save
from vae_lagging_encoder_tpu_torch.cli import image as cli_image
from vae_lagging_encoder_tpu_torch.cli import text as cli_text
from vae_lagging_encoder_tpu_torch.cli import toy as cli_toy
from vae_lagging_encoder_tpu_torch.data import MonoTextData
from vae_lagging_encoder_tpu_torch.config import DATASET_CONFIGS, get_config
from vae_lagging_encoder_tpu_torch.models import build_image_vae, build_text_vae
from vae_lagging_encoder_tpu_torch.train import optim
from vae_lagging_encoder_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params, to_jax_params

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(ni=8, enc_nh=12, dec_nh=12, nz=3)
IMAGE_SMALL = dict(nz=3, enc_layers=(4, 4), dec_layers=2, dec_filters=4, dec_kernel_size=5)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _jax_params(vocab=30, seed=0):
    vae = jax_build(jax_get_config("yahoo", **SMALL), vocab)
    return jax.device_get(vae.init(jax.random.PRNGKey(seed)))


def test_port_modules_import_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import vae_lagging_encoder_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'vae_lagging_encoder_tpu' or m.startswith('vae_lagging_encoder_tpu.'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 20 else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("module", ["utils.torch_import", "utils.profiling", "data.english"])
def test_new_modules_import_no_jax(module):
    """The modules ported with the training lifecycle, each imported alone;
    utils/torch_import.py reaches outside the package for numpy and torch only."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('vae_lagging_encoder_tpu_torch.{module}')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "             'vae_lagging_encoder_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    tree = ast.parse((REPO / "vae_lagging_encoder_tpu_torch" / f"{module.replace('.', '/')}.py")
                     .read_text())
    outside = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
               for a in n.names}
    outside |= {n.module.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module}
    allowed = {"__future__", "typing", "numpy", "torch", "argparse", "zipfile", "collections",
               "glob", "gzip", "json", "math", "os", "re", "ast", "sysconfig", "warnings",
               "contextlib", "heapq", "time"}
    assert outside <= allowed, outside - allowed
    if module == "utils.torch_import":
        assert outside - {"__future__", "typing", "argparse", "zipfile"} == {"numpy", "torch"}


@pytest.mark.parametrize("module", ["parallel", "parallel.launch", "parallel.dp",
                                    "parallel.tp", "evaluation", "data.native", "ops.ce_cuda"])
def test_parallel_and_native_modules_import_no_jax(module):
    """The data- and tensor-parallel modules, the evaluator re-exports, the
    native reader and the CE kernels' wrappers (csrc/ce_fwd.cu and
    csrc/ce_bwd.cu), each imported alone in a fresh interpreter."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('vae_lagging_encoder_tpu_torch.{module}')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "             'vae_lagging_encoder_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_spawned_ranks_import_no_jax(tmp_path):
    """What a rank imports when ``run_ranks`` starts it (the CLI's rank entry
    and the training loop, here beside the tests' own rank helpers): no JAX,
    nothing of the JAX package, no conftest."""
    import torch_port_ranks
    from vae_lagging_encoder_tpu_torch.parallel import run_ranks

    out = run_ranks(torch_port_ranks.jax_modules_loaded, 2, "cpu", workdir=str(tmp_path),
                    timeout=120)
    assert [o.result for o in out] == [[], []]


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    assert "vae_lagging_encoder_tpu_torch.ops" in names  # the walk sees nested imports
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "vae_lagging_encoder_tpu")]
    assert not bad, bad


def test_default_device_is_cuda_and_raises_without_it(tmp_path):
    _no_cuda()
    with pytest.raises(RuntimeError, match="cuda"):
        build_text_vae(get_config("yahoo", **SMALL), 30)
    with pytest.raises(RuntimeError, match="cuda"):
        cli_text.main(["--eval", "--exp_dir", str(tmp_path / "exp"), "--train_data",
                       str(tmp_path / "missing.txt")])
    with pytest.raises(RuntimeError, match="cuda"):
        build_image_vae(get_config("omniglot", **IMAGE_SMALL))
    with pytest.raises(RuntimeError, match="cuda"):
        cli_image.main(["--exp_dir", str(tmp_path / "exp_image"), "--train_data",
                        str(tmp_path / "missing.pt")])
    # each CLI refuses the other modality's dataset
    with pytest.raises(SystemExit, match="not an image dataset"):
        cli_image.main(["--dataset", "yahoo"])
    with pytest.raises(SystemExit, match="not a text dataset"):
        cli_text.main(["--dataset", "omniglot"])


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_package(tmp_path, alone):
    _no_cuda()
    script = REPO / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "cuda" in r.stderr.lower() and '"ok"' not in r.stdout


def test_from_jax_params_round_trip():
    params = _jax_params()
    sd = from_jax_params(params)
    vae = build_text_vae(get_config("yahoo", **SMALL), 30, device="cpu")
    vae.load_state_dict(sd)  # strict: every name and shape matches
    back = _flatten(to_jax_params(vae.state_dict()))
    want = _flatten(params)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    # a legacy merged LSTM bias "b" becomes b_ih = b, b_hh = 0
    legacy = {"wx": np.ones((2, 4)), "wh": np.ones((1, 4)), "b": np.arange(4.0)}
    sd = from_jax_params({"lstm": legacy})
    assert torch.equal(sd["lstm.b_ih"], torch.arange(4.0)) and not sd["lstm.b_hh"].any()


def test_checkpoint_loads_in_both_packages(tmp_path):
    params = _jax_params(seed=1)
    extra = {"epoch": 3, "val": {"loss": 1.5}, "hist": [1, 2], "note": None}
    jax_save(str(tmp_path / "jax.ckpt"), params, extra)
    p, e = load_checkpoint(str(tmp_path / "jax.ckpt"))
    assert e == extra
    for k, v in _flatten(params).items():
        np.testing.assert_array_equal(_flatten(p)[k], v)

    vae = build_text_vae(get_config("yahoo", **SMALL), 30, device="cpu")
    save_checkpoint(str(tmp_path / "port.ckpt"), to_jax_params(vae.state_dict()), {"epoch": 7})
    p2, e2 = jax_load(str(tmp_path / "port.ckpt"))
    assert e2 == {"epoch": 7}
    for name, t in vae.state_dict().items():
        np.testing.assert_array_equal(_flatten(p2)[name.replace(".", "/")], t.numpy())
    (tmp_path / "bad.ckpt").write_bytes(b"\x80\x04not a zip")
    with pytest.raises(ValueError, match="npz"):
        load_checkpoint(str(tmp_path / "bad.ckpt"))


def _corpus(d: Path):
    rng = np.random.RandomState(0)
    words = [f"w{i}" for i in range(26)]
    for split, n in (("train", 30), ("valid", 5), ("test", 10)):
        lines = [f"1\t" + " ".join(words[j] for j in rng.randint(0, 26, rng.randint(2, 12)))
                 for _ in range(n)]
        (d / f"{split}.txt").write_text("\n".join(lines) + "\n")
    return ["--train_data", str(d / "train.txt"), "--val_data", str(d / "valid.txt"),
            "--test_data", str(d / "test.txt")]


def test_cli_eval_on_jax_checkpoint(tmp_path):
    files = _corpus(tmp_path)
    params = _jax_params(vocab=30, seed=2)  # vocab: 26 words + 4 specials
    jax_save(str(tmp_path / "model.ckpt"), params, {"epoch": 0})
    dims = [f"--{k}={v}" for k, v in SMALL.items()]
    rc = cli_text.main(["--dataset", "yahoo", "--eval", "--load_path",
                        str(tmp_path / "model.ckpt"), "--device", "cpu", "--iw_nsamples", "10",
                        "--iw_batch", "5", "--exp_dir", str(tmp_path / "exp"), *files, *dims])
    assert rc == 0
    recs = [json.loads(l) for l in (tmp_path / "exp" / "log.metrics.jsonl").read_text().splitlines()]
    res = next(r for r in recs if r.get("split") == "test")
    for k in ("elbo_loss", "rec", "kl", "mi", "iw_nll", "iw_ppl"):
        assert np.isfinite(res[k]), (k, res)
    assert 0 <= res["au"] <= SMALL["nz"]


def test_cli_without_eval_trains_and_resumes(tmp_path):
    files = _corpus(tmp_path)
    dims = [f"--{k}={v}" for k, v in SMALL.items()]
    common = ["--dataset", "yahoo", "--device", "cpu", "--iw_nsamples", "4", "--iw_batch", "2",
              "--batch_size", "8", "--lr", "0.5", "--momentum", "0.5", "--warm_up", "1",
              "--aggressive", "1", "--log_niter", "2", *files, *dims]

    def run(name, epochs, *extra):
        ck = tmp_path / f"{name}.ckpt"
        rc = cli_text.main([*common, "--epochs", str(epochs), "--save_path", str(ck),
                            "--exp_dir", str(tmp_path / name), *extra])
        assert rc == 0
        recs = [json.loads(l) for l in
                (tmp_path / name / "log.metrics.jsonl").read_text().splitlines()]
        return ck, [r for r in recs if "val_loss" in r], next(r for r in recs
                                                               if r.get("split") == "test")

    _, full, _ = run("full", 3)
    ck, first, res = run("first", 2)
    assert [m["epoch"] for m in first] == [0, 1] and first[0]["inner_iters"] > 0
    for k in ("elbo_loss", "rec", "kl", "iw_nll"):
        assert np.isfinite(res[k]), (k, res)
    params, extra = jax_load(str(ck))  # the JAX package reads the port's checkpoint
    assert extra["epoch"] == 1 and extra["opt_state"]["enc"]["v"]["lstm"]["wh"].shape == (12, 48)
    vae = build_text_vae(get_config("yahoo", **SMALL), 30, device="cpu")
    vae.load_state_dict(from_jax_params(params))
    _, resumed, _ = run("resumed", 3, "--load_path", str(ck), "--resume")
    assert [m["epoch"] for m in resumed] == [2]
    # the same epoch as the uninterrupted run: parameters, optimizer state,
    # schedule, shuffle and draws all carried over
    for k in ("train_loss", "val_loss", "kl_weight", "lr", "inner_iters", "aggressive"):
        assert resumed[0][k] == full[2][k], (k, resumed[0][k], full[2][k])


def _jax_image(seed):
    """The JAX image model at IMAGE_SMALL, its params and an Adam state one
    step in (moments nonzero), all numpy."""
    jvae = jax_build_image(jax_get_config("omniglot", **IMAGE_SMALL))
    params = jax.device_get(jvae.init(jax.random.PRNGKey(seed)))
    init, adam = jax_optim.make_optimizer("adam")
    grads = jax.tree.map(lambda p: np.full_like(p, 0.5), params["enc"])
    _, state = adam(params["enc"], grads, init(params["enc"]), 1e-3)
    return jvae, params, jax.device_get(state)


def test_image_checkpoint_loads_in_both_packages(tmp_path):
    x = (np.random.RandomState(0).rand(3, 28, 28, 1) > 0.5).astype(np.float32)
    # JAX -> port: parameters (lists of blocks and layers) and Adam moments
    jvae, params, state = _jax_image(1)
    jax_save(str(tmp_path / "jax.ckpt"), params, {"opt_state": {"enc": state}})
    p, e = load_checkpoint(str(tmp_path / "jax.ckpt"))
    vae = build_image_vae(get_config("omniglot", **IMAGE_SMALL), device="cpu")
    vae.load_state_dict(from_jax_params(p))  # strict: every name and shape
    st = optim.state_from_tree(e["opt_state"], "cpu")["enc"]
    assert isinstance(state["m"]["blocks"], list)
    assert st["m"]["blocks.1.conv2"].abs().sum() > 0 and int(st["t"]) == 1
    # port -> JAX: the encoder gives the same (mu, logvar) in both packages
    with torch.no_grad():
        for prm in vae.parameters():
            prm.add_(torch.randn(prm.shape, generator=torch.Generator().manual_seed(2)) * 0.1)
        mu, logvar = vae.enc(torch.from_numpy(x))
    save_checkpoint(str(tmp_path / "port.ckpt"), to_jax_params(vae.state_dict()),
                    {"opt_state": optim.state_to_tree({"enc": st})})
    pj, ej = jax_load(str(tmp_path / "port.ckpt"))
    assert isinstance(pj["enc"]["blocks"], list) and isinstance(pj["dec"]["layers"], list)
    assert isinstance(ej["opt_state"]["enc"]["v"]["blocks"], list)
    mu_j, logvar_j = jvae.encoder.forward(jax.tree.map(np.asarray, pj["enc"]), x)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(logvar_j), atol=1e-5, rtol=1e-5)


def test_cli_image_trains_resumes_and_evaluates(tmp_path, monkeypatch):
    monkeypatch.setitem(DATASET_CONFIGS, "omniglot",
                        DATASET_CONFIGS["omniglot"].replace(**IMAGE_SMALL))
    rng = np.random.RandomState(0)
    np.savez(tmp_path / "omni.npz", **{k: (rng.rand(n, 28, 28, 1) ** 3).astype(np.float32)
                                       for k, n in (("train", 24), ("val", 8), ("test", 8))})
    common = ["--dataset", "omniglot", "--device", "cpu", "--train_data",
              str(tmp_path / "omni.npz"), "--batch_size", "8", "--iw_nsamples", "4",
              "--iw_batch", "2", "--warm_up", "1", "--aggressive", "1"]

    def run(name, *extra):
        rc = cli_image.main([*common, "--exp_dir", str(tmp_path / name), *extra])
        assert rc == 0
        recs = [json.loads(l) for l in
                (tmp_path / name / "log.metrics.jsonl").read_text().splitlines()]
        return [r for r in recs if "val_loss" in r], next(r for r in recs
                                                          if r.get("split") == "test")

    full, _ = run("full", "--epochs", "2", "--save_path", str(tmp_path / "full.ckpt"))
    ck = tmp_path / "first.ckpt"
    first, res = run("first", "--epochs", "1", "--save_path", str(ck))
    assert first[0]["inner_iters"] > 0
    for k in ("elbo_loss", "rec", "kl", "mi", "iw_nll", "iw_ppl"):
        assert np.isfinite(res[k]), (k, res)
    assert 0 <= res["au"] <= IMAGE_SMALL["nz"]
    params, extra = jax_load(str(ck))  # the JAX package reads the port's checkpoint
    assert extra["epoch"] == 0 and isinstance(extra["opt_state"]["dec"]["m"]["layers"], list)
    assert extra["opt_state"]["enc"]["v"]["blocks"][0]["down"].shape == (3, 3, 1, 4)
    resumed, _ = run("resumed", "--epochs", "2", "--save_path", str(tmp_path / "r.ckpt"),
                     "--load_path", str(ck), "--resume")
    assert [m["epoch"] for m in resumed] == [1]
    # the same epoch as the uninterrupted run: parameters, Adam state,
    # schedule, shuffle and draws all carried over
    for k in ("train_loss", "val_loss", "kl_weight", "lr", "inner_iters", "aggressive"):
        assert resumed[0][k] == full[1][k], (k, resumed[0][k], full[1][k])
    # --eval on the best checkpoint: the final evaluation of the same weights
    # on the same seeded noise as the training run's final evaluation
    _, ev = run("eval", "--eval", "--load_path", str(ck))
    for k in ("elbo_loss", "rec", "kl", "mi", "au", "iw_nll"):
        assert ev[k] == res[k], (k, ev[k], res[k])


@pytest.mark.parametrize("entry", ["text_prior", "text_reconstruct", "image_prior",
                                   "image_reconstruct", "toy"])
def test_generation_entry_points_need_cuda(tmp_path, monkeypatch, entry):
    _no_cuda()
    monkeypatch.chdir(tmp_path)  # nothing is written outside it
    mode = "--sample_from_prior" if entry.endswith("prior") else "--reconstruct"
    run = {"text": lambda: cli_text.main([mode, "--load_path", "missing.ckpt",
                                          "--exp_dir", "exp", "--train_data", "missing.txt"]),
           "image": lambda: cli_image.main([mode, "--load_path", "missing.ckpt",
                                            "--exp_dir", "exp", "--train_data", "missing.pt"]),
           "toy": lambda: cli_toy.main(["--dataset", "synthetic", "--plot_dir", "plots"])}
    with pytest.raises(RuntimeError, match="cuda"):
        run[entry.split("_")[0]]()
    assert not (tmp_path / "datasets").exists() and not (tmp_path / "plots").exists()


@pytest.mark.parametrize("mode,strategy", [("sample_from_prior", "greedy"),
                                           ("sample_from_prior", "sample"),
                                           ("sample_from_prior", "beam"),
                                           ("reconstruct", "greedy"),
                                           ("reconstruct", "sample"),
                                           ("reconstruct", "beam")])
def test_cli_text_generates_on_jax_checkpoint(tmp_path, mode, strategy):
    files = _corpus(tmp_path)
    jax_save(str(tmp_path / "model.ckpt"), _jax_params(vocab=30, seed=3), {"epoch": 0})
    out = tmp_path / "out.txt"
    rc = cli_text.main(["--dataset", "yahoo", f"--{mode}", "--decoding_strategy", strategy,
                        "--load_path", str(tmp_path / "model.ckpt"), "--device", "cpu",
                        "--num_samples", "6", "--max_decode_len", "9", "--batch_size", "4",
                        "--output_file", str(out), "--exp_dir", str(tmp_path / "exp"), *files,
                        *(f"--{k}={v}" for k, v in SMALL.items())])
    assert rc == 0
    lines = out.read_text().split("\n")[:-1]
    train = MonoTextData(str(tmp_path / "train.txt"), label=True)
    if mode == "reconstruct":  # the real rows of the first two test batches
        test = MonoTextData(str(tmp_path / "test.txt"), label=True, vocab=train.vocab)
        want = int(sum(b.row_weight.sum() for b in test.create_data_batch(4)[:2]))
    else:
        want = 6
    assert len(lines) == min(want, 6)
    for line in lines:
        words = line.split()
        assert len(words) <= 9 and all(w in train.vocab.word2id for w in words)
        assert not set(words) & {"<pad>", "<s>", "</s>"}
    rec = next(json.loads(l) for l in (tmp_path / "exp" / "log.metrics.jsonl").read_text()
               .splitlines() if '"generate"' in l)
    assert rec["sentences"] == len(lines) and rec["strategy"] == strategy
    assert rec["mode"] == ("prior" if mode == "sample_from_prior" else "reconstruct")


def _png_size(path):
    blob = Path(path).read_bytes()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n" and blob[12:16] == b"IHDR"
    return struct.unpack(">II", blob[16:24])  # (width, height)


@pytest.mark.parametrize("mode,n,size", [("sample_from_prior", 7, (7 * 30, 30)),
                                         ("reconstruct", 5, (10 * 30, 30)),
                                         ("reconstruct", 8, (10 * 30, 2 * 30))])
def test_cli_image_generates_on_jax_checkpoint(tmp_path, monkeypatch, mode, n, size):
    monkeypatch.setitem(DATASET_CONFIGS, "omniglot",
                        DATASET_CONFIGS["omniglot"].replace(**IMAGE_SMALL))
    rng = np.random.RandomState(1)
    np.savez(tmp_path / "omni.npz", **{k: (rng.rand(m, 28, 28, 1) ** 3).astype(np.float32)
                                       for k, m in (("train", 8), ("val", 4), ("test", 6))})
    _, params, _ = _jax_image(4)
    jax_save(str(tmp_path / "img.ckpt"), params, {})
    rc = cli_image.main(["--dataset", "omniglot", f"--{mode}", "--num_samples", str(n),
                         "--load_path", str(tmp_path / "img.ckpt"), "--device", "cpu",
                         "--train_data", str(tmp_path / "omni.npz"),
                         "--exp_dir", str(tmp_path / "exp")])
    assert rc == 0
    name = "samples.png" if mode == "sample_from_prior" else "recon.png"
    assert _png_size(tmp_path / "exp" / name) == size  # 6 test images: 12 cells at most
    rec = next(json.loads(l) for l in (tmp_path / "exp" / "log.metrics.jsonl").read_text()
               .splitlines() if '"generate"' in l)
    assert rec["images"] == (n if mode == "sample_from_prior" else min(n, 6))
    assert rec["seconds"] > 0
