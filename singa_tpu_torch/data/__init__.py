from .synthetic import synthetic_image_batches
