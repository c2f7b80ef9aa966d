"""paddle_tpu_torch.vision (port of ``paddle_tpu/vision/``; reference:
python/paddle/vision/): transforms, datasets, the detection ops and the
model zoo."""
from paddle_tpu_torch.vision import datasets, models, ops, transforms  # noqa: F401


_image_backend = "pil"


def set_image_backend(backend):
    """Reference vision.image.set_image_backend ('pil' | 'cv2')."""
    global _image_backend
    if backend not in ("pil", "cv2"):
        raise ValueError(f"backend must be 'pil' or 'cv2', got {backend!r}")
    _image_backend = backend


def get_image_backend():
    return _image_backend


def image_load(path, backend=None):
    """Load an image file via the configured backend (reference
    vision.image.image_load)."""
    b = backend or _image_backend
    if b not in ("pil", "cv2"):
        raise ValueError(f"backend must be 'pil' or 'cv2', got {b!r}")
    if b == "cv2":
        try:
            import cv2

            return cv2.imread(path)
        except ImportError as e:
            raise ImportError(
                "cv2 is not installed; use the 'pil' backend") from e
    from PIL import Image

    return Image.open(path)
