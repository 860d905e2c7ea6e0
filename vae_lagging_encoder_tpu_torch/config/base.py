"""Per-dataset experiment configuration.

The port's own copy of ``vae_lagging_encoder_tpu/config/base.py``: the same
``ExperimentConfig`` field names and the same entries of
``DATASET_CONFIGS`` (yahoo, yelp, docs_english, synthetic, omniglot), merged with CLI
flags the same way (flags win; see cli/common.py).

``use_pallas`` keeps its name and meaning: True selects the kernel route
(the hand-written CUDA kernels on a CUDA device, their plain PyTorch
versions on the CPU, both with the kernel route's numerics); False selects
the numerics of the JAX package's scan/XLA route.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass
class ExperimentConfig:
    # --- identity -----------------------------------------------------
    dataset: str = "yahoo"
    model_type: str = "text"

    # --- data ---------------------------------------------------------
    train_data: str = "datasets/yahoo_data/yahoo.train.txt"
    val_data: str = "datasets/yahoo_data/yahoo.valid.txt"
    test_data: str = "datasets/yahoo_data/yahoo.test.txt"
    batch_size: int = 32
    # pad+bucket batching: every batch is padded to one of these lengths
    length_buckets: Tuple[int, ...] = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512)

    # --- model (text) ---------------------------------------------------
    ni: int = 512       # word-embedding dim
    enc_nh: int = 1024  # encoder LSTM hidden dim
    dec_nh: int = 1024  # decoder LSTM hidden dim
    nz: int = 32        # latent dim
    dec_dropout_in: float = 0.5
    dec_dropout_out: float = 0.5

    # --- model (image) --------------------------------------------------
    img_size: Tuple[int, int, int] = (28, 28, 1)
    enc_layers: Tuple[int, ...] = (64, 64, 64)
    dec_kernel_size: int = 7
    dec_layers: int = 8
    dec_filters: int = 64
    # "stack": the JAX package's model (the fields above); "published":
    # jxhe's config_omniglot.py model (the fields below): the ResNet encoder
    # with batch norm and the bottleneck PixelCNN with direct connections
    image_arch: str = "stack"
    enc_head: int = 512
    dec_kernels: Tuple[int, ...] = (7, 7, 7, 7, 7, 5, 5, 5, 5, 3, 3, 3, 3)
    dec_hidden: int = 64
    dec_bottleneck: int = 32
    latent_maps: int = 4

    # --- training -------------------------------------------------------
    epochs: int = 100
    optim: str = "sgd"
    lr: float = 1.0
    momentum: float = 0.0
    clip_grad: float = 5.0
    kl_start: float = 0.1
    warm_up: int = 10
    aggressive: bool = False
    burn_max_iters: int = 100
    burn_window: int = 15
    decay_epoch: int = 2
    lr_decay: float = 0.5
    max_decay: int = 5
    nsamples: int = 1
    seed: int = 783435

    # --- evaluation -------------------------------------------------------
    iw_nsamples: int = 500        # importance-weighted NLL samples
    iw_batch: int = 100           # IW chunk size (ns in the reference's nll_iw)
    eval: bool = False
    load_path: str = ""
    resume: bool = False
    test_nepoch: int = 5

    # --- bookkeeping -------------------------------------------------------
    log_niter: int = 50
    save_path: str = ""
    exp_dir: str = ""
    profile_dir: str = ""   # capture a torch.profiler trace of one epoch here
    # None = auto (the built-in corpora are "<label>\t<sentence>" lines);
    # an explicit --label 0/1 wins
    label: bool | None = None

    # --- execution -------------------------------------------------------
    compute_dtype: str = "float32"   # "float32" | "bfloat16" matmul inputs
    use_pallas: bool = False         # True = the kernel route (see module doc)
    epoch_segment: int | None = None
    dp_devices: int = 1
    tp_devices: int = 1
    loop_unroll: int = 1
    # mid-epoch autosave every N outer training steps to <save_path>.auto
    # (0 = off); --resume --load_path <save_path>.auto re-enters the epoch
    autosave_niter: int = 0

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def _text_cfg(name: str, **kw) -> ExperimentConfig:
    base = dict(
        dataset=name,
        model_type="text",
        train_data=f"datasets/{name}_data/{name}.train.txt",
        val_data=f"datasets/{name}_data/{name}.valid.txt",
        test_data=f"datasets/{name}_data/{name}.test.txt",
    )
    base.update(kw)
    return ExperimentConfig(**base)


DATASET_CONFIGS = {
    # the reference's config/config_yahoo.py params
    "yahoo": _text_cfg("yahoo", ni=512, enc_nh=1024, dec_nh=1024, nz=32,
                       batch_size=32, epochs=100, warm_up=10, kl_start=0.1,
                       use_pallas=True),
    # the reference's config/config_yelp.py params
    "yelp": _text_cfg("yelp", ni=512, enc_nh=1024, dec_nh=1024, nz=32,
                      batch_size=32, epochs=100, warm_up=10, kl_start=0.1,
                      use_pallas=True),
    # real-English docstring corpus at yahoo dims (written by
    # python -m vae_lagging_encoder_tpu_torch.data.english)
    "docs_english": _text_cfg("docs_english", ni=512, enc_nh=1024,
                              dec_nh=1024, nz=32, batch_size=32, epochs=100,
                              warm_up=10, kl_start=0.1, use_pallas=True),
    # the reference's config/config_synthetic.py params
    "synthetic": _text_cfg("synthetic", ni=50, enc_nh=50, dec_nh=50, nz=1,
                           batch_size=32, epochs=40, warm_up=10, kl_start=0.1,
                           dec_dropout_in=0.0, dec_dropout_out=0.0,
                           length_buckets=(8, 16, 24, 32, 48, 64)),
    # the reference's config/config_omniglot.py params; Adam 1e-3 as the
    # JAX package chose (SGD lr 1.0 diverges on the PixelCNN stack there)
    "omniglot": ExperimentConfig(
        dataset="omniglot", model_type="image",
        train_data="datasets/omniglot_data/omniglot.pt",
        val_data="", test_data="",
        batch_size=50, epochs=500, nz=32, warm_up=10, kl_start=0.1,
        optim="adam", lr=1e-3,
        dec_dropout_in=0.0, dec_dropout_out=0.0,
    ),
}


def get_config(dataset: str, **overrides) -> ExperimentConfig:
    """Look up the per-dataset config and apply CLI overrides (flags win)."""
    if dataset not in DATASET_CONFIGS:
        raise KeyError(f"unknown dataset {dataset!r}; known: {sorted(DATASET_CONFIGS)}")
    return DATASET_CONFIGS[dataset].replace(**overrides)
