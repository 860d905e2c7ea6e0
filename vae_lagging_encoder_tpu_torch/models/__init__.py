import torch

from ..ops.build import resolve_device
from .dec_lstm import LSTMDecoder
from .dec_pixelcnn import PixelCNNDecoderV2
from .dec_pixelcnn_bn import BottleneckPixelCNNDecoder
from .decoder import DecoderBase
from .enc_lstm import GaussianLSTMEncoder
from .enc_resnet import ResNetEncoderV2
from .enc_resnet_bn import BNResNetEncoder
from .encoder import (GaussianEncoderBase, calc_mi, eval_inference_dist,
                      gaussian_kl, reparameterize)
from .vae import VAE


def build_text_vae(cfg, vocab_size: int, device="cuda",
                   generator: torch.Generator | None = None) -> VAE:
    """The text VAE of an ExperimentConfig, initialised with the reference's
    recipe from ``generator`` (default: seeded with ``cfg.seed``) on the CPU
    and then moved to ``device``. ``cfg.use_pallas`` selects the kernel route."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    enc = GaussianLSTMEncoder(vocab_size, cfg.ni, cfg.enc_nh, cfg.nz,
                              kernel_route=cfg.use_pallas, compute_dtype=dtype)
    dec = LSTMDecoder(vocab_size, cfg.ni, cfg.dec_nh, cfg.nz,
                      dropout_in=cfg.dec_dropout_in, dropout_out=cfg.dec_dropout_out,
                      kernel_route=cfg.use_pallas, compute_dtype=dtype)
    vae = VAE(enc, dec)
    vae.reset_parameters(generator or torch.Generator().manual_seed(cfg.seed))
    return vae.to(dev)


def build_image_vae(cfg, device="cuda", generator: torch.Generator | None = None) -> VAE:
    """The OmniGlot model of an ExperimentConfig (ResNet encoder + PixelCNN
    decoder), initialised from ``generator`` (default: seeded with
    ``cfg.seed``) on the CPU and then moved to ``device``. ``cfg.image_arch``
    picks the model: ``"stack"``, the JAX package's (its init recipe), or
    ``"published"``, jxhe's ``config_omniglot.py`` model with batch norm
    (PyTorch's default init; f32 only)."""
    dev = resolve_device(device)
    if cfg.image_arch == "published":
        if cfg.compute_dtype != "float32":
            raise ValueError("the published OmniGlot model runs in float32 only")
        enc = BNResNetEncoder(cfg.nz, channels=cfg.enc_layers, img_size=cfg.img_size,
                              head=cfg.enc_head)
        dec = BottleneckPixelCNNDecoder(cfg.nz, img_size=cfg.img_size, kernels=cfg.dec_kernels,
                                        hidden=cfg.dec_hidden, bottleneck=cfg.dec_bottleneck,
                                        latent_maps=cfg.latent_maps)
    elif cfg.image_arch == "stack":
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        enc = ResNetEncoderV2(cfg.nz, channels=cfg.enc_layers, img_size=cfg.img_size,
                              compute_dtype=dtype)
        dec = PixelCNNDecoderV2(cfg.nz, img_size=cfg.img_size, n_layers=cfg.dec_layers,
                                filters=cfg.dec_filters, first_kernel=cfg.dec_kernel_size,
                                compute_dtype=dtype)
    else:
        raise ValueError(f"image_arch {cfg.image_arch!r}: not 'stack' or 'published'")
    vae = VAE(enc, dec)
    vae.reset_parameters(generator or torch.Generator().manual_seed(cfg.seed))
    return vae.to(dev)


__all__ = [
    "BNResNetEncoder", "BottleneckPixelCNNDecoder", "DecoderBase", "GaussianEncoderBase",
    "GaussianLSTMEncoder", "LSTMDecoder", "PixelCNNDecoderV2", "ResNetEncoderV2", "VAE",
    "build_image_vae", "build_text_vae", "calc_mi", "eval_inference_dist", "gaussian_kl",
    "reparameterize",
]
