"""The port's synthetic corpus and toy posterior-mean tracing against the JAX
package's.

- ``generate_synthetic_corpus`` / ``generate_flagship_corpus`` equal for the
  same seed; the split files of ``ensure_synthetic_dataset`` (written by
  ``load_text_datasets`` in a directory without ``datasets/``) and of
  ``ensure_flagship_dataset`` byte-identical; a partial set refused;
- ``cli.toy.main`` end to end on the CPU (as ``tests/test_cli_toy.py``);
- the epoch -1 pairs on the JAX package's initial parameters equal to the
  JAX toy's within 1e-5; the z grid equal to ``jnp.arange``'s bit for bit;
- a latent of more than one dimension refused.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_lagging_encoder_tpu.cli import toy as jax_cli_toy
from vae_lagging_encoder_tpu.config import get_config as jax_get_config
from vae_lagging_encoder_tpu.data import MonoTextData as JaxMonoTextData
from vae_lagging_encoder_tpu.data import synthetic as jax_synthetic
from vae_lagging_encoder_tpu.models import build_text_vae as jax_build
from vae_lagging_encoder_tpu_torch.cli import toy as cli_toy
from vae_lagging_encoder_tpu_torch.config import get_config
from vae_lagging_encoder_tpu_torch.data import BucketedPool, MonoTextData, synthetic
from vae_lagging_encoder_tpu_torch.models import build_text_vae
from vae_lagging_encoder_tpu_torch.train.loop import load_text_datasets
from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

SPLITS = ("train", "valid", "test")


def _small_corpus(root, n=120, vocab_size=25, seed=5):
    """A small labeled corpus where the synthetic config expects its files."""
    os.makedirs(root, exist_ok=True)
    sents, topics = synthetic.generate_synthetic_corpus(num_sentences=n, vocab_size=vocab_size,
                                                        min_len=4, max_len=10, seed=seed)
    cut = {"train": slice(0, 80), "valid": slice(80, 100), "test": slice(100, 120)}
    for split, sl in cut.items():
        with open(os.path.join(root, f"synthetic.{split}.txt"), "w") as fh:
            for t, s in zip(topics[sl], sents[sl]):
                fh.write(f"{t}\t" + " ".join(s) + "\n")


def _files(root, name):
    return [open(os.path.join(root, f"{name}.{s}.txt"), "rb").read() for s in SPLITS]


@pytest.mark.parametrize("kw", [dict(num_sentences=50, seed=3),
                                dict(num_sentences=30, vocab_size=12, min_len=2, max_len=6,
                                     num_topics=3, seed=11)])
def test_generate_synthetic_corpus_matches_jax(kw):
    got = synthetic.generate_synthetic_corpus(**kw)
    assert got == jax_synthetic.generate_synthetic_corpus(**kw)


def test_generate_flagship_corpus_matches_jax():
    kw = dict(num_sentences=40, vocab_size=500, num_states=6, num_topics=3, seed=4)
    assert synthetic.generate_flagship_corpus(**kw) == jax_synthetic.generate_flagship_corpus(**kw)


def test_synthetic_corpus_written_on_a_fresh_checkout(tmp_path, monkeypatch):
    """``--dataset synthetic`` in a directory without ``datasets/``: the
    corpus is written (16000 sentences), byte for byte the JAX package's."""
    monkeypatch.chdir(tmp_path)
    train, val, test = load_text_datasets(get_config("synthetic"))
    assert (len(train), len(val), len(test)) == (14000, 1000, 1000)
    root = tmp_path / "datasets" / "synthetic_data"
    jax_synthetic.ensure_synthetic_dataset(root=str(tmp_path / "jax"))
    assert _files(root, "synthetic") == _files(tmp_path / "jax", "synthetic")
    # a second call reads the files as they are
    mtime = os.path.getmtime(root / "synthetic.train.txt")
    synthetic.ensure_synthetic_dataset()
    assert os.path.getmtime(root / "synthetic.train.txt") == mtime


def test_ensure_flagship_dataset_matches_jax_and_refuses_partial(tmp_path):
    for pkg, d in ((synthetic, "port"), (jax_synthetic, "jax")):
        paths = pkg.ensure_flagship_dataset("yelp", root=str(tmp_path / d), seed=2,
                                            num_sentences=44)
        assert sorted(paths) == sorted(SPLITS)
    assert _files(tmp_path / "port", "yelp") == _files(tmp_path / "jax", "yelp")
    os.remove(tmp_path / "port" / "yelp.test.txt")
    with pytest.raises(FileExistsError, match="refusing"):
        synthetic.ensure_flagship_dataset("yelp", root=str(tmp_path / "port"), num_sentences=44)


@pytest.mark.parametrize("zmin,zmax,dz", [(-20.0, 20.0, 0.1), (-5.0, 5.0, 0.5),
                                          (-3.0, 2.95, 0.05), (-1.0, 1.0, 0.3)])
def test_z_grid_matches_jnp_arange(zmin, zmax, dz):
    want = np.asarray(jnp.arange(zmin, zmax, dz))
    got = cli_toy.z_grid(zmin, zmax, dz)
    assert got.shape == (len(want), 1) and got.dtype == torch.float32
    assert got[:, 0].numpy().tobytes() == want.tobytes()
    if (zmin, zmax, dz) == (-20.0, 20.0, 0.1):
        assert len(want) == 400


TOY_ARGS = ["--dataset", "synthetic", "--batch_size", "8", "--num_plot", "20",
            "--zmin", "-5", "--zmax", "5", "--dz", "0.5"]


@pytest.mark.parametrize("aggressive", [0, 1])
def test_toy_cli_end_to_end(tmp_path, monkeypatch, aggressive):
    monkeypatch.chdir(tmp_path)
    _small_corpus("datasets/synthetic_data")
    rc = cli_toy.main([*TOY_ARGS, "--device", "cpu", "--epochs", "2", "--plot_niter", "1",
                       "--aggressive", str(aggressive), "--plot_dir", "plots",
                       "--exp_dir", "exp"])
    assert rc == 0
    with open(f"plots/synthetic_aggr{aggressive}_seed783435.pkl", "rb") as fh:
        trace = pickle.load(fh)
    assert [t["epoch"] for t in trace] == [-1, 0, 1]  # record(-1) + one per epoch
    for t in trace:
        pairs = t["pairs"]
        assert isinstance(pairs, np.ndarray) and pairs.dtype == np.float32
        assert pairs.shape[1] == 2 and 0 < pairs.shape[0] <= 20
        assert np.isfinite(pairs).all()
        assert (np.abs(pairs[:, 0]) <= 5.0).all()  # on the grid's support
    metrics = (tmp_path / "exp" / "log.metrics.jsonl").read_text()
    assert metrics.count('"toy_probe"') == 3 and metrics.count('"toy_epoch"') == 2


def test_toy_epoch_minus_one_pairs_match_jax(tmp_path, monkeypatch):
    """The JAX toy's first record (its initial parameters) against the
    port's probe on the same parameters, probe batches and default grid."""
    monkeypatch.chdir(tmp_path)
    _small_corpus("datasets/synthetic_data")
    args = ["--dataset", "synthetic", "--batch_size", "8", "--num_plot", "20", "--epochs", "0"]
    assert jax_cli_toy.main([*args, "--plot_dir", "jax"]) == 0
    with open("jax/synthetic_aggr0_seed783435.pkl", "rb") as fh:
        want = pickle.load(fh)[0]
    assert want["epoch"] == -1
    jcfg = jax_get_config("synthetic", batch_size=8)
    vocab = JaxMonoTextData(jcfg.train_data, label=True).vocab
    params = jax.device_get(jax_build(jcfg, len(vocab)).init(jax.random.PRNGKey(jcfg.seed)))
    cfg = get_config("synthetic", batch_size=8)
    train = MonoTextData(cfg.train_data, label=True)
    assert len(train.vocab) == len(vocab)
    vae = build_text_vae(cfg, len(train.vocab), device="cpu")
    vae.load_state_dict(from_jax_params(params))
    pool = BucketedPool(train.create_data_batch(cfg.batch_size, cfg.length_buckets), "cpu")
    got = cli_toy.probe_pairs(vae, cli_toy.probe_batches(pool, 20), cli_toy.z_grid(-20, 20, 0.1),
                              20)
    assert got.shape == want["pairs"].shape == (20, 2)
    np.testing.assert_allclose(got, want["pairs"], atol=1e-5, rtol=0)


def test_toy_rejects_multidim_latent():
    with pytest.raises(SystemExit, match="nz=1"):
        cli_toy.init_config(["--dataset", "yahoo"])
