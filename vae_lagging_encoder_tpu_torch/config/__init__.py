from .base import DATASET_CONFIGS, ExperimentConfig, get_config

__all__ = ["ExperimentConfig", "get_config", "DATASET_CONFIGS"]
