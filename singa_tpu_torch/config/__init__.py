from .schema import (
    ModelConfig, NetConfig, LayerConfig, ParamConfig, UpdaterConfig,
    ClusterConfig, ConfigError, load_model_config, load_cluster_config,
    model_config_from_text, model_config_from_dict,
    model_config_to_text, config_to_dict,
)
from . import textproto
