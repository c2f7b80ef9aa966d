"""Vision transforms on numpy CHW or HWC arrays (port of
``paddle_tpu/vision/transforms.py``; reference:
python/paddle/vision/transforms/).

They run on the host, in the DataLoader's forked workers, which must not
touch the card: numpy, and for ``Resize`` torch's CPU ``interpolate``.
Every random transform draws from numpy's global RNG in the JAX
package's order, so under one ``np.random.seed`` both packages crop,
flip and jitter alike. ``Resize(int)`` makes a square (size x size), as
the JAX package's does, not a resize of the shorter side.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Compose", "Normalize", "ToTensor", "Transpose", "Resize",
           "RandomCrop", "CenterCrop", "RandomHorizontalFlip", "Pad",
           "RandomResizedCrop"]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.data_format = data_format

    def __call__(self, img):
        img = np.asarray(img, dtype=np.float32)
        if self.data_format == "CHW":
            m = self.mean.reshape(-1, 1, 1)
            s = self.std.reshape(-1, 1, 1)
        else:
            m, s = self.mean, self.std
        return (img - m) / s


class ToTensor:
    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        img = np.asarray(img, dtype=np.float32)
        if img.ndim == 3 and img.shape[-1] in (1, 3, 4) and \
                self.data_format == "CHW":
            img = img.transpose(2, 0, 1)
        if img.max() > 1.5:
            img = img / 255.0
        return img


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.transpose(np.asarray(img), self.order)


class Resize:
    """Linear resampling with an antialiasing filter when it shrinks (the
    JAX package's ``jax.image.resize(method="linear")``): torch's CPU
    ``interpolate(mode="bilinear", antialias=True)``, half-pixel
    centres, the weights renormalised at the edges. A 3-D array with 1, 3
    or 4 leading channels is CHW, any other HWC."""

    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        import torch
        import torch.nn.functional as tF

        img = np.asarray(img, dtype=np.float32)
        chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
        t = torch.from_numpy(np.ascontiguousarray(
            img if chw else img.transpose(2, 0, 1)))
        out = tF.interpolate(t[None], size=self.size, mode="bilinear",
                             antialias=True, align_corners=False)[0]
        out = out.numpy()
        return out if chw else np.ascontiguousarray(out.transpose(1, 2, 0))


class RandomCrop:
    def __init__(self, size, padding=None, pad_if_needed=False):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        img = np.asarray(img)
        chw = img.shape[0] in (1, 3, 4)
        if self.padding:
            p = self.padding
            pads = [(0, 0), (p, p), (p, p)] if chw else [(p, p), (p, p),
                                                         (0, 0)]
            img = np.pad(img, pads, mode="constant")
        h, w = (img.shape[1], img.shape[2]) if chw else (img.shape[0],
                                                         img.shape[1])
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return img[:, i:i + th, j:j + tw] if chw else img[i:i + th,
                                                          j:j + tw]


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        img = np.asarray(img)
        chw = img.shape[0] in (1, 3, 4)
        h, w = (img.shape[1], img.shape[2]) if chw else (img.shape[0],
                                                         img.shape[1])
        th, tw = self.size
        i = (h - th) // 2
        j = (w - tw) // 2
        return img[:, i:i + th, j:j + tw] if chw else img[i:i + th,
                                                          j:j + tw]


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self._resize = Resize(self.size)

    def __call__(self, img):
        img = np.asarray(img)
        chw = img.shape[0] in (1, 3, 4)
        h, w = (img.shape[1], img.shape[2]) if chw else (img.shape[0],
                                                         img.shape[1])
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            tw = int(round(np.sqrt(target * ar)))
            th = int(round(np.sqrt(target / ar)))
            if th <= h and tw <= w:
                i = np.random.randint(0, h - th + 1)
                j = np.random.randint(0, w - tw + 1)
                crop = img[:, i:i + th, j:j + tw] if chw else \
                    img[i:i + th, j:j + tw]
                return self._resize(crop)
        return self._resize(img)


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            img = np.asarray(img)
            chw = img.shape[0] in (1, 3, 4)
            return img[..., ::-1].copy() if chw else img[:, ::-1].copy()
        return img


class Pad:
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding = padding

    def __call__(self, img):
        img = np.asarray(img)
        p = self.padding
        chw = img.shape[0] in (1, 3, 4)
        pads = [(0, 0), (p, p), (p, p)] if chw else [(p, p), (p, p), (0, 0)]
        return np.pad(img, pads, mode="constant")


# ---------------------------------------------------------------------------
# color / photometric ops (reference transforms.py BrightnessTransform:
# ContrastTransform/SaturationTransform/HueTransform/ColorJitter/
# Grayscale; host-side preprocessing, so numpy like the rest)
# ---------------------------------------------------------------------------

def _as_chw(img):
    """Match the file's dual-layout convention (chw = shape[0] in
    1/3/4): return (CHW float array, layout tag)."""
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        return img[None], "hw"
    if img.shape[0] in (1, 3, 4):
        return img, "chw"
    return img.transpose(2, 0, 1), "hwc"


def _restore(img, fmt):
    if fmt == "hw":
        return img[0]
    if fmt == "hwc":
        return img.transpose(1, 2, 0)
    return img


def _chw_float(img):
    img, fmt = _as_chw(img)
    scale = 255.0 if img.max() > 1.5 else 1.0
    return img / scale, scale, fmt


def _rand_factor(delta):
    return float(np.random.uniform(max(0.0, 1.0 - delta), 1.0 + delta))


class BrightnessTransform:
    def __init__(self, value, keys=None):
        self.value = float(value)

    def __call__(self, img):
        x, scale, fmt = _chw_float(img)
        out = np.clip(x * _rand_factor(self.value), 0.0, 1.0)
        return _restore(out * scale, fmt)


class ContrastTransform:
    def __init__(self, value, keys=None):
        self.value = float(value)

    def __call__(self, img):
        x, scale, fmt = _chw_float(img)
        mean = x.mean()
        out = np.clip((x - mean) * _rand_factor(self.value) + mean,
                      0.0, 1.0)
        return _restore(out * scale, fmt)


class SaturationTransform:
    def __init__(self, value, keys=None):
        self.value = float(value)

    def __call__(self, img):
        x, scale, fmt = _chw_float(img)
        gray = (0.299 * x[0] + 0.587 * x[1] + 0.114 * x[2])[None]
        out = np.clip(gray + (x - gray) * _rand_factor(self.value),
                      0.0, 1.0)
        return _restore(out * scale, fmt)


def _rgb_to_hsv(x):
    r, g, b = x[0], x[1], x[2]
    mx = np.max(x, axis=0)
    mn = np.min(x, axis=0)
    d = mx - mn
    h = np.zeros_like(mx)
    nz = d > 1e-8
    idx = nz & (mx == r)
    h[idx] = ((g - b)[idx] / d[idx]) % 6
    idx = nz & (mx == g)
    h[idx] = (b - r)[idx] / d[idx] + 2
    idx = nz & (mx == b)
    h[idx] = (r - g)[idx] / d[idx] + 4
    h = h / 6.0
    s = np.where(mx > 1e-8, d / np.maximum(mx, 1e-8), 0.0)
    return np.stack([h, s, mx])


def _hsv_to_rgb(x):
    h, s, v = x[0] * 6.0, x[1], x[2]
    i = np.floor(h).astype(np.int32) % 6
    f = h - np.floor(h)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b])


class HueTransform:
    def __init__(self, value, keys=None):
        self.value = float(value)  # in [0, 0.5]

    def __call__(self, img):
        x, scale, fmt = _chw_float(img)
        hsv = _rgb_to_hsv(x)
        shift = float(np.random.uniform(-self.value, self.value))
        hsv[0] = (hsv[0] + shift) % 1.0
        return _restore(np.clip(_hsv_to_rgb(hsv), 0.0, 1.0) * scale,
                        fmt)


class ColorJitter:
    """reference transforms.py ColorJitter: random order of the four
    photometric jitters."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0,
                 hue=0.0, keys=None):
        self.ts = []
        if brightness:
            self.ts.append(BrightnessTransform(brightness))
        if contrast:
            self.ts.append(ContrastTransform(contrast))
        if saturation:
            self.ts.append(SaturationTransform(saturation))
        if hue:
            self.ts.append(HueTransform(hue))

    def __call__(self, img):
        for i in np.random.permutation(len(self.ts)):
            img = self.ts[i](img)
        return img


class Grayscale:
    def __init__(self, num_output_channels=1, keys=None):
        self.n = num_output_channels

    def __call__(self, img):
        x, fmt = _as_chw(img)
        gray = (0.299 * x[0] + 0.587 * x[1] + 0.114 * x[2])[None]
        return _restore(np.repeat(gray, self.n, axis=0), fmt)


class RandomVerticalFlip:
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            img = np.asarray(img)
            chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
            # vertical = flip the HEIGHT axis in either layout
            return (img[:, ::-1, :] if chw else img[::-1]).copy()
        return np.asarray(img)


# ---------------------------------------------------------------------------
# geometric warps (inverse-map bilinear resampling; reference uses cv2/
# PIL backends — same math)
# ---------------------------------------------------------------------------

def _warp_affine(img, mat, fill=0.0):
    """img: CHW; mat: 2x3 OUTPUT->INPUT affine (inverse map)."""
    from scipy import ndimage

    c, h, w = img.shape
    out = np.empty_like(img, dtype=np.float32)
    for ci in range(c):
        out[ci] = ndimage.affine_transform(
            img[ci].astype(np.float32), mat[:, :2], offset=mat[:, 2],
            output_shape=(h, w), order=1, mode="constant", cval=fill)
    return out


def _center_affine(h, w, angle_deg, translate, scale, shear_deg):
    """Build the OUTPUT->INPUT matrix for rotate/translate/scale/shear
    about the image center."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    a = np.deg2rad(angle_deg)
    sx = np.deg2rad(shear_deg[0])
    sy = np.deg2rad(shear_deg[1])
    # forward: T(center) R S Shear T(-center) + translate
    rs = np.asarray([
        [np.cos(a + sy), -np.sin(a + sx)],
        [np.sin(a + sy), np.cos(a + sx)],
    ]) * scale
    # operate in (y, x): build the full forward matrix, then invert
    fwd = np.eye(3)
    fwd[:2, :2] = rs
    fwd[0, 2] = cy - rs[0, 0] * cy - rs[0, 1] * cx + translate[1]
    fwd[1, 2] = cx - rs[1, 0] * cy - rs[1, 1] * cx + translate[0]
    bwd = np.linalg.inv(fwd)
    return bwd[:2, :]


class RandomRotation:
    def __init__(self, degrees, interpolation="bilinear", expand=False,
                 center=None, fill=0, keys=None):
        if np.isscalar(degrees):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.fill = fill

    def __call__(self, img):
        x, fmt = _as_chw(img)
        ang = float(np.random.uniform(*self.degrees))
        m = _center_affine(x.shape[1], x.shape[2], ang, (0, 0), 1.0,
                           (0, 0))
        return _restore(_warp_affine(x, m, fill=self.fill), fmt)


class RandomAffine:
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        if np.isscalar(degrees):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.fill = fill

    def __call__(self, img):
        x, fmt = _as_chw(img)
        h, w = x.shape[1:]
        ang = float(np.random.uniform(*self.degrees))
        tx = ty = 0.0
        if self.translate is not None:
            tx = float(np.random.uniform(-self.translate[0],
                                         self.translate[0]) * w)
            ty = float(np.random.uniform(-self.translate[1],
                                         self.translate[1]) * h)
        sc = 1.0 if self.scale is None else \
            float(np.random.uniform(*self.scale))
        sh = (0.0, 0.0)
        if self.shear is not None:
            shd = self.shear if not np.isscalar(self.shear) \
                else (-abs(self.shear), abs(self.shear))
            sh = (float(np.random.uniform(shd[0], shd[1])), 0.0)
        m = _center_affine(h, w, ang, (tx, ty), sc, sh)
        return _restore(_warp_affine(x, m, fill=self.fill), fmt)


class RandomPerspective:
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.fill = fill

    def __call__(self, img):
        from scipy import ndimage

        x, fmt = _as_chw(img)
        if np.random.rand() >= self.prob:
            return _restore(x, fmt)
        c, h, w = x.shape
        d = self.distortion_scale
        dx = w * d / 2.0
        dy = h * d / 2.0
        src = np.asarray([[0, 0], [0, w - 1], [h - 1, 0],
                          [h - 1, w - 1]], np.float64)
        dst = src + np.stack([
            np.random.uniform(-dy, dy, 4),
            np.random.uniform(-dx, dx, 4)], axis=1)
        # homography dst->src (inverse map): solve 8-dof DLT
        A, b = [], []
        for (ys, xs), (yd, xd) in zip(src, dst):
            A.append([yd, xd, 1, 0, 0, 0, -ys * yd, -ys * xd])
            b.append(ys)
            A.append([0, 0, 0, yd, xd, 1, -xs * yd, -xs * xd])
            b.append(xs)
        p = np.linalg.solve(np.asarray(A), np.asarray(b))
        H = np.asarray([[p[0], p[1], p[2]], [p[3], p[4], p[5]],
                        [p[6], p[7], 1.0]])
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        ones = np.ones_like(yy, np.float64)
        pts = np.stack([yy, xx, ones]).reshape(3, -1)
        mapped = H @ pts
        my = (mapped[0] / mapped[2]).reshape(h, w)
        mx = (mapped[1] / mapped[2]).reshape(h, w)
        out = np.empty_like(x)
        for ci in range(c):
            out[ci] = ndimage.map_coordinates(
                x[ci], [my, mx], order=1, mode="constant",
                cval=self.fill)
        return _restore(out, fmt)


class RandomErasing:
    """reference transforms.py RandomErasing (cutout with random box)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def __call__(self, img):
        x, fmt = _as_chw(img)
        x = x.copy()
        if np.random.rand() >= self.prob:
            return _restore(x, fmt)
        c, h, w = x.shape
        area = h * w
        for _ in range(10):
            target = np.random.uniform(*self.scale) * area
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target * ar)))
            ew = int(round(np.sqrt(target / ar)))
            if eh < h and ew < w:
                i = np.random.randint(0, h - eh + 1)
                j = np.random.randint(0, w - ew + 1)
                if self.value == "random":
                    x[:, i:i + eh, j:j + ew] = np.random.normal(
                        size=(c, eh, ew))
                else:
                    x[:, i:i + eh, j:j + ew] = self.value
                return _restore(x, fmt)
        return _restore(x, fmt)


__all__ += ["BrightnessTransform", "ContrastTransform",
            "SaturationTransform", "HueTransform", "ColorJitter",
            "Grayscale", "RandomVerticalFlip", "RandomRotation",
            "RandomAffine", "RandomPerspective", "RandomErasing"]


# ---------------------------------------------------------------------------
# functional API + BaseTransform (reference
# python/paddle/vision/transforms/functional.py and transforms.py
# BaseTransform) — each functional reuses the class implementations'
# helpers so the two surfaces cannot diverge.
# ---------------------------------------------------------------------------

class BaseTransform:
    """Reference BaseTransform: subclasses implement _apply_image (and
    optionally _apply_* for other keys); __call__ routes per key."""

    def __init__(self, keys=None):
        self.keys = keys or ("image",)

    def _apply_image(self, image):
        raise NotImplementedError

    def __call__(self, inputs):
        if not isinstance(inputs, (list, tuple)):
            return self._apply_image(inputs)
        outs = []
        for key, data in zip(self.keys, inputs):
            fn = getattr(self, f"_apply_{key}", None)
            outs.append(fn(data) if fn else data)
        return tuple(outs)


def to_tensor(pic, data_format="CHW"):
    """PIL/ndarray -> float tensor in [0, 1] (reference F.to_tensor)."""
    from paddle_tpu_torch.core.tensor import Tensor

    raw = np.asarray(pic)
    arr = raw.astype(np.float32)
    if raw.dtype == np.uint8:
        arr = arr / 255.0  # dtype-keyed, like the reference (a dark
        # uint8 image must scale the same as a bright one)
    if arr.ndim == 2:
        arr = arr[..., None]
    if data_format == "CHW" and arr.shape[-1] in (1, 3, 4):
        arr = arr.transpose(2, 0, 1)
    return Tensor(arr)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def crop(img, top, left, height, width):
    arr = np.asarray(img)
    chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
    if chw:
        return arr[:, top:top + height, left:left + width]
    return arr[top:top + height, left:left + width]


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)


def hflip(img):
    arr = np.asarray(img)
    chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
    return arr[..., ::-1].copy() if chw else arr[:, ::-1].copy()


def vflip(img):
    arr = np.asarray(img)
    chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
    return arr[:, ::-1].copy() if chw else arr[::-1].copy()


def pad(img, padding, fill=0, padding_mode="constant"):
    return Pad(padding, fill, padding_mode)(img)


def adjust_brightness(img, brightness_factor):
    x, fmt = _as_chw(np.asarray(img))
    return _restore(np.clip(x * brightness_factor, 0.0, 1.0), fmt)


def adjust_contrast(img, contrast_factor):
    x, fmt = _as_chw(np.asarray(img))
    mean = x.mean()
    return _restore(np.clip(mean + contrast_factor * (x - mean),
                            0.0, 1.0), fmt)


def adjust_hue(img, hue_factor):
    x, fmt = _as_chw(np.asarray(img))
    hsv = _rgb_to_hsv(x)
    hsv[0] = (hsv[0] + hue_factor) % 1.0
    return _restore(np.clip(_hsv_to_rgb(hsv), 0.0, 1.0), fmt)


def rotate(img, angle, interpolation="nearest", expand=False,
           center=None, fill=0):
    x, fmt = _as_chw(np.asarray(img))
    m = _center_affine(x.shape[1], x.shape[2], float(angle), (0, 0),
                       1.0, (0, 0))
    return _restore(_warp_affine(x, m, fill=fill), fmt)


def affine(img, angle, translate, scale, shear, interpolation="nearest",
           fill=0, center=None):
    x, fmt = _as_chw(np.asarray(img))
    sh = shear if isinstance(shear, (list, tuple)) else (shear, 0.0)
    m = _center_affine(x.shape[1], x.shape[2], float(angle),
                       tuple(translate), float(scale), tuple(sh))
    return _restore(_warp_affine(x, m, fill=fill), fmt)


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """Reference F.perspective: warp so startpoints map to endpoints."""
    x, fmt = _as_chw(np.asarray(img))
    # _warp_perspective maps OUTPUT pixels back to source positions, so
    # it needs the inverse transform: solve startpoints <- endpoints
    mat = _perspective_coeffs(startpoints, endpoints)
    out = _warp_perspective(x, mat, fill=fill)
    return _restore(out, fmt)


def _perspective_coeffs(src, dst):
    a = []
    b = []
    for (sx, sy), (dx, dy) in zip(src, dst):
        a.append([dx, dy, 1, 0, 0, 0, -sx * dx, -sx * dy])
        a.append([0, 0, 0, dx, dy, 1, -sy * dx, -sy * dy])
        b.extend([sx, sy])
    coef = np.linalg.solve(np.asarray(a, np.float64),
                           np.asarray(b, np.float64))
    return np.append(coef, 1.0).reshape(3, 3)


def _warp_perspective(img, mat, fill=0.0):
    c, h, w = img.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ones = np.ones_like(xs)
    pts = np.stack([xs, ys, ones]).reshape(3, -1).astype(np.float64)
    src = mat @ pts
    sx = src[0] / src[2]
    sy = src[1] / src[2]
    valid = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    sxc = np.clip(np.round(sx), 0, w - 1).astype(np.int64)
    syc = np.clip(np.round(sy), 0, h - 1).astype(np.int64)
    out = img[:, syc, sxc]
    out = np.where(valid[None], out, fill)
    return out.reshape(c, h, w)


def to_grayscale(img, num_output_channels=1):
    return Grayscale(num_output_channels)(img)


def erase(img, i, j, h, w, v, inplace=False):
    """Zero/fill a region (reference F.erase); v is the fill value."""
    from paddle_tpu_torch.core.tensor import Tensor as _T

    is_tensor = isinstance(img, _T)
    arr = np.array(img.numpy() if is_tensor else img)
    chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
    if chw:
        arr[:, i:i + h, j:j + w] = v
    else:
        arr[i:i + h, j:j + w] = v
    return _T(arr) if is_tensor else arr


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    arr = np.asarray(img, np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        return (arr - mean.reshape(-1, 1, 1)) / std.reshape(-1, 1, 1)
    return (arr - mean) / std


__all__ += ["BaseTransform", "to_tensor", "resize", "crop",
            "center_crop", "hflip", "vflip", "pad",
            "adjust_brightness", "adjust_contrast", "adjust_hue",
            "rotate", "affine", "perspective", "to_grayscale", "erase",
            "normalize"]
