"""On-read image resizing + JPEG EXIF orientation fixing.

Behavioral match of reference weed/images/:
  resized()             resizing.go:15 Resized — ?width=&height=&mode=
                        on volume GETs; only downscales (a source
                        smaller than the target passes through), with
                        fit / fill / default(thumbnail-or-resize) modes
  fix_jpg_orientation() orientation.go:14 FixJpgOrientation — applied
                        to .jpg uploads on the write path so stored
                        pixels are upright and EXIF rotation quirks
                        never reach clients

Pillow does the pixel work; when it is unavailable both functions
degrade to pass-through (the reference likewise returns the original
bytes on any decode error).
"""

from __future__ import annotations

import io

_IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".gif"}

_degrade_warned = False


def _pil():
    try:
        from PIL import Image

        return Image
    except ImportError:
        _warn_degraded()
        return None


def _warn_degraded() -> None:
    # The reference always ships its imaging dep (disintegration/imaging),
    # so a ?width= GET always resizes. Without Pillow we pass the original
    # bytes through with a 200 — make that deviation observable instead of
    # silent: one warning at first degrade, and /status reports it.
    global _degrade_warned
    if not _degrade_warned:
        _degrade_warned = True
        from seaweedfs_tpu_torch.util import wlog

        wlog.warning(
            "Pillow unavailable: image resizing/orientation disabled; "
            "?width=/?height= requests will return original bytes"
        )


_resizing_enabled: bool | None = None


def resizing_enabled() -> bool:
    """True when Pillow is importable (does not emit the degrade
    warning). Cached: failed imports are not cached by Python, and this
    sits on the volume /status path."""
    global _resizing_enabled
    if _resizing_enabled is None:
        try:
            from PIL import Image  # noqa: F401

            _resizing_enabled = True
        except ImportError:
            _resizing_enabled = False
    return _resizing_enabled


def is_image_ext(ext: str) -> bool:
    return ext.lower() in _IMAGE_EXTS


def _format_for(ext: str) -> str:
    e = ext.lower()
    if e in (".jpg", ".jpeg"):
        return "JPEG"
    if e == ".png":
        return "PNG"
    if e == ".gif":
        return "GIF"
    return "PNG"


def resized(
    ext: str, data: bytes, width: int, height: int, mode: str = ""
) -> tuple[bytes, int, int]:
    """(bytes, w, h); pass-through when no resize applies
    (resizing.go:15 semantics, Lanczos filter)."""
    if width == 0 and height == 0:
        return data, 0, 0
    Image = _pil()
    if Image is None:
        return data, 0, 0
    try:
        src = Image.open(io.BytesIO(data))
        src.load()
    except Exception:  # noqa: BLE001 - undecodable: serve original bytes
        return data, 0, 0
    src_w, src_h = src.size
    needs = (src_w > width and width != 0) or (src_h > height and height != 0)
    if not needs:
        return data, src_w, src_h

    resample = Image.LANCZOS
    if mode == "fit":
        dst = src.copy()
        dst.thumbnail((width or src_w, height or src_h), resample)
    elif mode == "fill":
        from PIL import ImageOps

        dst = ImageOps.fit(src, (width or src_w, height or src_h), resample)
    else:
        if width == height and width != 0 and src_w != src_h:
            # square thumbnail: center-crop then scale (imaging.Thumbnail)
            from PIL import ImageOps

            dst = ImageOps.fit(src, (width, height), resample)
        else:
            # plain resize; 0 on one axis keeps aspect
            if width == 0:
                width = max(1, src_w * height // src_h)
            if height == 0:
                height = max(1, src_h * width // src_w)
            dst = src.resize((width, height), resample)

    buf = io.BytesIO()
    fmt = _format_for(ext)
    if fmt == "JPEG" and dst.mode not in ("RGB", "L"):
        dst = dst.convert("RGB")
    dst.save(buf, format=fmt)
    return buf.getvalue(), dst.size[0], dst.size[1]


def fix_jpg_orientation(data: bytes) -> bytes:
    """Bake the EXIF orientation into the pixels (orientation.go:14);
    returns the input unchanged when there is nothing to fix. Uses
    Pillow's canonical exif_transpose — a hand-rolled rotate/flip
    table is exactly the kind of thing that silently disagrees with
    the spec on half the orientation values."""
    Image = _pil()
    if Image is None:
        return data
    try:
        img = Image.open(io.BytesIO(data))
        orient = img.getexif().get(0x0112, 1)  # Orientation tag
    except Exception:  # noqa: BLE001
        return data
    if orient == 1 or orient not in range(2, 9):
        # 1 = upright; out-of-range tags (corrupt cameras) must pass
        # through untouched, not get generation-lossed by a no-op
        # re-encode
        return data
    try:
        from PIL import ImageOps

        fixed = ImageOps.exif_transpose(img)  # also clears the tag
        buf = io.BytesIO()
        if fixed.mode not in ("RGB", "L"):
            fixed = fixed.convert("RGB")
        # quality 95: the write path must not visibly degrade photos
        # just to bake in the rotation
        fixed.save(buf, format="JPEG", quality=95, exif=fixed.getexif().tobytes())
        return buf.getvalue()
    except Exception:  # noqa: BLE001
        return data
