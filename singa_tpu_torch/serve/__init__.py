from .engine import InferenceEngine, ServeSpec, left_pad
