from .image_folder import ImageFolder, load_image, prefetch_to_device

__all__ = ["ImageFolder", "load_image", "prefetch_to_device"]
