"""Input handlers: prepare model inputs from stored items.

The port's copy of ``panoptikon_tpu/jobs/input_handlers.py``, held to it unit for unit
by ``tests/test_torch_host_copies.py``: host code only, with imports of the
port. PIL imports lazily, as in the reference.

The reference's handler registry (jobs/extraction/input_handlers/): each
model group declares an ``input_spec.handler`` + opts in the registry;
the pipeline routes items through the matching handler:

- ``image_frames``  — stored frames (or the file itself for images), with
  ``max_frames`` and the aspect-ratio / pixel slicing rules below;
- ``audio_tracks``  — audio payload bytes;
- ``extracted_text``— previously extracted text rows (derived extractors);
- ``md5`` / ``sha256_md5_path`` — hash-only payloads (lookup taggers).

Slicing semantics are the reference's exactly
(image_frames.rs:252-400): an image whose long/short ratio exceeds
``(ratio_larger/ratio_smaller) · max_multiplier`` is cut along its long
axis into ``ceil(ratio / (base · target_multiplier))`` strips (images at or
under ``minimum_size`` are never sliced); ``pixels`` mode grids images
larger than ``pixel_max_size`` down to ``pixel_target_size`` tiles.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Optional


@dataclass
class SliceSettings:
    mode: str = "aspect-ratio"
    ratio_larger: float = 16.0
    ratio_smaller: float = 9.0
    max_multiplier: float = 2.0
    target_multiplier: float = 1.5
    minimum_size: float = 1024.0
    pixel_target_size: float = 1024.0
    pixel_max_size: float = 4096.0

    @classmethod
    def from_opts(cls, opts: Optional[dict]) -> "SliceSettings":
        if not opts:
            return cls()
        fields = {k: v for k, v in opts.items() if k in cls.__dataclass_fields__}
        return cls(**fields)


def is_excessive_ratio(width: float, height: float, s: SliceSettings) -> bool:
    ratio = width / height if width >= height else height / width
    return ratio > (s.ratio_larger / s.ratio_smaller) * s.max_multiplier


def slices_needed(width: float, height: float, s: SliceSettings) -> int:
    ratio = width / height if width >= height else height / width
    base = s.ratio_larger / s.ratio_smaller
    if ratio <= base * s.max_multiplier:
        return 1
    return max(1, int(-(-ratio // (base * s.target_multiplier))))


def grid_for_pixels(width: float, height: float, s: SliceSettings) -> tuple[int, int]:
    rows = max(1, int(-(-height // s.pixel_target_size)))
    cols = max(1, int(-(-width // s.pixel_target_size)))
    return rows, cols


def slice_image_bytes(payload: bytes, settings: SliceSettings) -> list[bytes]:
    """Apply the slicing decision to one encoded image; returns the slice
    payloads (identity when no slicing applies)."""
    from PIL import Image

    with Image.open(io.BytesIO(payload)) as im:
        width, height = im.size
        if settings.mode == "aspect-ratio":
            if max(width, height) <= settings.minimum_size or not is_excessive_ratio(
                width, height, settings
            ):
                return [payload]
            n = slices_needed(width, height, settings)
            out = []
            if width >= height:
                step = width // n
                for i in range(n):
                    left = i * step
                    right = width if i == n - 1 else left + step
                    out.append(_encode(im.crop((left, 0, right, height)), im.format))
            else:
                step = height // n
                for i in range(n):
                    top = i * step
                    bottom = height if i == n - 1 else top + step
                    out.append(_encode(im.crop((0, top, width, bottom)), im.format))
            return out
        if settings.mode == "pixels":
            if max(width, height) <= settings.pixel_max_size:
                return [payload]
            rows, cols = grid_for_pixels(width, height, settings)
            out = []
            for r in range(rows):
                for c in range(cols):
                    left = c * width // cols
                    right = (c + 1) * width // cols if c < cols - 1 else width
                    top = r * height // rows
                    bottom = (r + 1) * height // rows if r < rows - 1 else height
                    out.append(_encode(im.crop((left, top, right, bottom)), im.format))
            return out
        return [payload]


def _encode(im, fmt: Optional[str]) -> bytes:
    buf = io.BytesIO()
    fmt = fmt if fmt in ("PNG", "JPEG", "WEBP") else "PNG"
    if fmt == "JPEG" and im.mode not in ("RGB", "L"):
        im = im.convert("RGB")
    im.save(buf, format=fmt)
    return buf.getvalue()


def prepare_image_frames(
    conn,
    item_id: int,
    sha256: str,
    payload: bytes,
    *,
    max_frames: int = 4,
    slice_frames: bool = False,
    slice_settings: Optional[dict] = None,
) -> list[bytes]:
    """image_frames handler: stored frames for video items (storage DB),
    the file payload for stills; slicing per settings."""
    frames = [
        row[0]
        for row in conn.execute(
            "SELECT frame FROM storage.frames WHERE item_sha256=? ORDER BY idx LIMIT ?",
            (sha256, max_frames),
        ).fetchall()
    ]
    images = frames if frames else [payload]
    images = images[:max_frames]
    if slice_frames:
        settings = SliceSettings.from_opts(slice_settings)
        sliced: list[bytes] = []
        for img in images:
            try:
                sliced.extend(slice_image_bytes(img, settings))
            except Exception:
                sliced.append(img)
        images = sliced
    return images


def prepare_audio_tracks(
    path: str, payload: bytes, mime: str, *, target_rate: int = 16_000
) -> list[bytes]:
    """audio_tracks handler (input_handlers/mod.rs:25-40): WAV payloads
    pass through; other audio containers and video soundtracks transcode
    to mono 16 kHz WAV via jobs/media (ffmpeg-gated — a missing decoder
    raises MediaError and the item ledgers as blocked)."""
    import io as _io
    import wave

    from panoptikon_tpu_torch.jobs import media

    if mime == "audio/wav":
        return [payload]
    pcm, rate = media.extract_audio_pcm(path, mime, target_rate=target_rate)
    buf = _io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        import numpy as np

        w.writeframes(
            (np.clip(pcm, -1.0, 1.0) * 32767).astype(np.int16).tobytes()
        )
    return [buf.getvalue()]


HANDLERS = {
    "image_frames": prepare_image_frames,
    "audio_tracks": prepare_audio_tracks,
}
