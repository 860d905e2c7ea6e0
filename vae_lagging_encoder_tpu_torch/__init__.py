"""PyTorch/CUDA port of vae_lagging_encoder_tpu for NVIDIA Hopper GPUs.

The JAX package ``vae_lagging_encoder_tpu`` stays the reference; this
package imports nothing of it (nor JAX). Layout mirrors it: config, data,
models, ops (the hand-written CUDA kernels' wrappers and their build),
train, cli, utils; CUDA sources are in ``csrc/``. Entry points run on the
GPU ("cuda") unless the caller passes ``device="cpu"``.

Ported: training and the final evaluation (ELBO, MI, active units,
importance-weighted NLL) of the text VAE — ``python -m
vae_lagging_encoder_tpu_torch.cli.text`` — and of the OmniGlot image VAE —
``python -m vae_lagging_encoder_tpu_torch.cli.image`` — with generation,
the toy probe (``cli.toy``), the training lifecycle, data and tensor
parallelism over ``torch.distributed`` (``parallel/``) and the native text
reader (``data/native.py``).
"""
