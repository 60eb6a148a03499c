"""Appended-outro detection for videos (platform end cards).

The port's copy of ``panoptikon_tpu/jobs/outro.py``, held to it unit for unit
by ``tests/test_torch_host_copies.py``: host code only, with imports of the
port.

The reference's two-stage detector (media_tools/outro.rs, design doc
docs/video-outro-detection-design.md), with the pixel logic in vectorized
NumPy and the ffmpeg plumbing gated on availability:

- stage 1 (rejector): a single final frame squashed to 32×32; its
  per-channel median must sit within ``TOL`` of the card color;
- stage 2: the last 7 s at 30 fps, 48 px wide; per-frame "card" scoring
  (median on background AND ≥45% of pixels flat w.r.t. the frame's own
  median), then the gap-tolerant terminal run and four structural rules:
  R0 run ≥ 1 s; R1 a lead ≥ 0.4 s exists (a card is a transition, not a
  state); R2 run ≤ 5 s; R3 ink confined to ≤ 60% of rows.

Any behavioral change bumps ``OUTRO_DETECTOR_VERSION`` — verdicts persist
versioned so a new detector can re-run exactly the rows it doesn't
recognize.
"""

from __future__ import annotations

import shutil
import subprocess
from dataclasses import dataclass
from typing import Optional

import numpy as np

OUTRO_DETECTOR_VERSION = 1
KIND_NONE = "none"
KIND_TIKTOK_CARD = "tiktok_card"

CARD_BG = np.array([12, 13, 25], dtype=np.float64)
TOL = 8.0
BGFRAC_TOL = 12.0
BGFRAC_MIN = 0.45
RUN_MEAN_MIN = 0.90
MIN_RUN_S = 1.0
MIN_LEAD_S = 0.40
K_CAP_S = 5.0
INK_DELTA = 25
INK_ROWS_MAX = 0.60
TAIL_S = 7
FPS = 30
W = 48


@dataclass
class OutroVerdict:
    kind: str  # 'tiktok_card' | 'none'
    outro_seconds: float
    reject_reason: Optional[str] = None
    version: int = OUTRO_DETECTOR_VERSION

    @property
    def kind_string(self) -> str:
        return f"{self.kind}/{self.version}"


def frame_median(frame: np.ndarray) -> np.ndarray:
    """Per-channel median over an (H, W, 3) uint8 frame. NumPy's median on
    an even count averages the two central values — the same tie rule the
    reference implements by hand (outro.rs:485-498)."""
    return np.median(frame.reshape(-1, 3).astype(np.float64), axis=0)


def on_background(median: np.ndarray) -> bool:
    return float(np.max(np.abs(median - CARD_BG))) <= TOL


def background_fraction(frame: np.ndarray, median: np.ndarray) -> float:
    flat = frame.reshape(-1, 3).astype(np.float64)
    near = np.max(np.abs(flat - median[None, :]), axis=1) <= BGFRAC_TOL
    return float(near.mean()) if flat.size else 0.0


def frame_is_card(frame: np.ndarray) -> bool:
    median = frame_median(frame)
    return on_background(median) and background_fraction(frame, median) >= BGFRAC_MIN


def ink_row_fraction(frame: np.ndarray) -> float:
    """R3: fraction of rows with any pixel further than INK_DELTA from the
    card color."""
    if frame.size == 0:
        return 0.0
    delta = np.max(
        np.abs(frame.astype(np.int32) - CARD_BG.astype(np.int32)[None, None, :]),
        axis=2,
    )
    inked_rows = (delta > INK_DELTA).any(axis=1)
    return float(inked_rows.mean())


def terminal_run_start(card: np.ndarray) -> int:
    """Smallest index that is itself a card frame and from which ≥
    RUN_MEAN_MIN of the remainder are (gap tolerance bridges the animated
    search-bar sweep)."""
    count = len(card)
    start = count
    suffix_true = 0
    for index in range(count - 1, -1, -1):
        if not card[index]:
            continue
        suffix_true += 1
        if suffix_true / (count - index) >= RUN_MEAN_MIN:
            start = index
    return start


def verdict_from_tail(card: np.ndarray, last_frame: np.ndarray) -> OutroVerdict:
    count = len(card)
    start = terminal_run_start(np.asarray(card, dtype=bool))
    run = (count - start) / FPS
    lead = start / FPS
    if run < MIN_RUN_S:
        return OutroVerdict(KIND_NONE, 0.0, "no_run")
    if lead < MIN_LEAD_S:
        return OutroVerdict(KIND_NONE, 0.0, "no_boundary")
    if run > K_CAP_S:
        return OutroVerdict(KIND_NONE, 0.0, "too_long")
    if ink_row_fraction(last_frame) > INK_ROWS_MAX:
        return OutroVerdict(KIND_NONE, 0.0, "layout")
    return OutroVerdict(KIND_TIKTOK_CARD, run)


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def detect_outro_from_frames(tail: np.ndarray) -> OutroVerdict:
    """Decoder-agnostic stage 2: caller supplies the last-7s@30fps tail
    (any decoder — the scan uses OpenCV via jobs/media.decode_tail_frames,
    which needs no system ffmpeg)."""
    if tail is None or len(tail) == 0:
        return OutroVerdict(KIND_NONE, 0.0, "decode_failed")
    if not on_background(frame_median(tail[-1])):
        return OutroVerdict(KIND_NONE, 0.0, "stage1_color")
    card = np.array([frame_is_card(f) for f in tail], dtype=bool)
    return verdict_from_tail(card, tail[-1])


def detect_outro(path: str) -> Optional[OutroVerdict]:
    """Full two-stage detection; None when ffmpeg is unavailable (the
    caller ledgers a blocked attempt — blocker='ffmpeg')."""
    if not ffmpeg_available():
        return None
    # Stage 1: one final frame at 32x32, rejector only.
    final = _decode_frames(path, seek_tail=1, fps=None, width=32, height=32, count=1)
    if final is None or len(final) == 0:
        return OutroVerdict(KIND_NONE, 0.0, "decode_failed")
    if not on_background(frame_median(final[-1])):
        return OutroVerdict(KIND_NONE, 0.0, "stage1_color")
    # Stage 2: last 7 s at 30 fps, width 48.
    tail = _decode_frames(path, seek_tail=TAIL_S, fps=FPS, width=W, height=None)
    if tail is None or len(tail) == 0:
        return OutroVerdict(KIND_NONE, 0.0, "decode_failed")
    card = np.array([frame_is_card(f) for f in tail], dtype=bool)
    return verdict_from_tail(card, tail[-1])


def _decode_frames(path, *, seek_tail, fps, width, height, count=None):
    scale = f"scale={width}:{height if height else -2}"
    args = ["ffmpeg", "-v", "error", "-sseof", f"-{seek_tail}", "-i", path]
    if fps:
        args += ["-vf", f"fps={fps},{scale}"]
    else:
        args += ["-vf", scale]
    if count:
        args += ["-frames:v", str(count)]
    args += ["-f", "rawvideo", "-pix_fmt", "rgb24", "-"]
    try:
        out = subprocess.run(args, capture_output=True, timeout=120).stdout
    except Exception:
        return None
    if not out:
        return None
    if height is None:
        # Height unknown (aspect-preserving): probe from byte count across
        # plausible heights is fragile; require fps mode to use -2 only with
        # a separate probe. Practical approach: ffprobe the height.
        height = _probe_scaled_height(path, width)
        if height is None:
            return None
    frame_bytes = width * height * 3
    n = len(out) // frame_bytes
    return np.frombuffer(out[: n * frame_bytes], dtype=np.uint8).reshape(
        n, height, width, 3
    )


def _probe_scaled_height(path, width) -> Optional[int]:
    if shutil.which("ffprobe") is None:
        return None
    try:
        out = subprocess.run(
            ["ffprobe", "-v", "error", "-select_streams", "v:0",
             "-show_entries", "stream=width,height", "-of", "csv=p=0", path],
            capture_output=True, timeout=30,
        ).stdout.decode().strip()
        w, h = (int(x) for x in out.split(",")[:2])
        scaled = round(h * width / w / 2) * 2
        return max(2, scaled)
    except Exception:
        return None
