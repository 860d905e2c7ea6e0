"""The benchmark of vae_lagging_encoder_tpu_torch on one NVIDIA H100 (README.md)."""
