from .graph import Graph, GraphError
from .layers import (Context, Layer, LayerError, LAYER_REGISTRY, ParamSpec,
                     create_layer, register_layer)
from .net import NeuralNet, build_net
