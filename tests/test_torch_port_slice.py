"""The slice as a whole: the port's ``run_final_eval`` against the JAX
package's ``run_final_eval`` on a tiny labeled corpus (3 test batches), the
same weights, and the JAX package's own noise.

The port's evaluators take a ``noise(batch_index, site, shape)`` provider;
here it replays the JAX key schedule of ``train/loop.py::run_final_eval``:
key = PRNGKey(seed + 1); per batch i, k_i = fold_in(site key, i) with site
keys key (ELBO), fold_in(key, 1) (MI) and fold_in(key, 3) (IW); ELBO draws
normal(split(k_i)[0], (B, 1, nz)), MI normal(split(k_i)[1], (B, 1, nz)),
IW chunk j normal(fold_in(split(k_i)[1], j), (B, ns, nz)).

Both packages take their scan/XLA route (``use_pallas`` off), whose
numerics match exactly in f32; the kernel route's modules are held against
the JAX Pallas kernels in test_torch_port_models.py / _vae.py.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_lagging_encoder_tpu.config import get_config as jax_get_config
from vae_lagging_encoder_tpu.data import BucketedPool as JaxPool
from vae_lagging_encoder_tpu.data import MonoTextData as JaxText
from vae_lagging_encoder_tpu.models import build_text_vae as jax_build
from vae_lagging_encoder_tpu.train.loop import run_final_eval as jax_final_eval
from vae_lagging_encoder_tpu.utils.exp_utils import Logger as JaxLogger
from vae_lagging_encoder_tpu_torch.config import get_config
from vae_lagging_encoder_tpu_torch.data import BucketedPool, MonoTextData
from vae_lagging_encoder_tpu_torch.models import build_text_vae
from vae_lagging_encoder_tpu_torch.train.loop import run_final_eval
from vae_lagging_encoder_tpu_torch.utils.exp_utils import Logger
from vae_lagging_encoder_tpu_torch.utils.jax_params import from_jax_params

DIMS = dict(ni=16, enc_nh=32, dec_nh=32, nz=4, batch_size=8, use_pallas=False,
            iw_nsamples=20, iw_batch=10, seed=5)
# f32 on both sides, sums in another order: per-sentence values agree to
# ~1e-5 relative, the corpus means of O(10-100) nats to ~1e-4 absolute
RTOL = 1e-5
ATOL = 1e-4


def jax_key_noise(seed):
    key = jax.random.PRNGKey(seed + 1)
    site_keys = {"elbo": key, "mi": jax.random.fold_in(key, 1), "iw": jax.random.fold_in(key, 3)}

    def noise(i, site, shape):
        if site in ("elbo", "mi"):
            k = jax.random.split(jax.random.fold_in(site_keys[site], i))[0 if site == "elbo" else 1]
        else:
            k_i = jax.random.split(jax.random.fold_in(site_keys["iw"], i))[1]
            k = jax.random.fold_in(k_i, int(site[2:]))
        return torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))

    return noise


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    words = [f"w{i}" for i in range(80)]
    paths = {}
    for split, n in (("train", 60), ("valid", 8), ("test", 20)):
        lines = []
        for i in range(n):
            ln = rng.randint(3, 25)
            lines.append(f"{i % 3}\t" + " ".join(words[j] for j in rng.zipf(1.5, ln) % 80))
        paths[split] = d / f"{split}.txt"
        paths[split].write_text("\n".join(lines) + "\n")
    return paths


def test_run_final_eval_matches_jax(corpus):
    files = dict(train_data=str(corpus["train"]), val_data=str(corpus["valid"]),
                 test_data=str(corpus["test"]))
    jcfg = jax_get_config("yahoo", **DIMS, **files)
    cfg = get_config("yahoo", **DIMS, **files)

    jtrain = JaxText(jcfg.train_data, label=True)
    jtest = JaxText(jcfg.test_data, label=True, vocab=jtrain.vocab)
    vocab = len(jtrain.vocab)
    jpool = JaxPool(jtest.create_data_batch(jcfg.batch_size, jcfg.length_buckets))
    jvae = jax_build(jcfg, vocab)
    params = jax.device_get(jvae.init(jax.random.PRNGKey(3)))
    # an encoder whose posterior depends on x, so KL, MI and AU are not ~0
    rng = np.random.RandomState(1)
    for k in ("wx", "wh"):
        params["enc"]["lstm"][k] = rng.uniform(-0.3, 0.3, params["enc"]["lstm"][k].shape
                                               ).astype(np.float32)
    params["enc"]["emb"] = rng.randn(*params["enc"]["emb"].shape).astype(np.float32)
    params["enc"]["linear"] = (rng.randn(32, 8) * 2.0).astype(np.float32)
    want = jax_final_eval(jcfg, jvae, jax.tree.map(jnp.asarray, params), jpool,
                          JaxLogger(quiet=True))

    train = MonoTextData(cfg.train_data, label=True)
    test = MonoTextData(cfg.test_data, label=True, vocab=train.vocab)
    assert len(train.vocab) == vocab and test.data == jtest.data
    pool = BucketedPool(test.create_data_batch(cfg.batch_size, cfg.length_buckets), "cpu")
    assert pool.num_batches == jpool.num_batches == 3
    vae = build_text_vae(cfg, vocab, device="cpu")
    vae.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        got = run_final_eval(cfg, vae, pool, Logger(quiet=True), noise=jax_key_noise(cfg.seed))

    assert set(got) == set(want)
    assert got["au"] == want["au"]
    for k in ("elbo_loss", "rec", "kl", "mi", "iw_nll", "iw_ppl"):
        assert math.isclose(got[k], want[k], rel_tol=RTOL, abs_tol=ATOL), (k, got[k], want[k])
