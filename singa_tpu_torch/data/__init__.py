from .discovery import discover_input_shapes
from .synthetic import synthetic_image_batches
