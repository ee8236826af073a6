"""Video output.

Ports `save_video` / `to_uint8_frames` (`turbodiffusion_tpu/utils/
video_io.py:18-51`); the uint8 conversion runs in numpy: clip to [0, 1],
then v*255 + 0.5 truncated, as the JAX package's host op does.
"""

from __future__ import annotations

import os

import numpy as np


def to_uint8_frames(video_c_t_h_w: np.ndarray) -> np.ndarray:
    """(C, T, H, W) float in [0, 1] -> (T, H, W, C) uint8."""
    v = np.asarray(video_c_t_h_w, np.float32)
    v = (np.clip(v, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return np.transpose(v, (1, 2, 3, 0))


def save_video(video_c_t_h_w: np.ndarray, path: str, fps: int = 16) -> str:
    """Save a video; returns the path actually written. Without an mp4
    writer (imageio + ffmpeg), writes an .npz frame archive and the first and
    last frames as PNGs."""
    frames = to_uint8_frames(video_c_t_h_w)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    if path.endswith((".mp4", ".webm", ".mkv", ".gif")):
        try:
            import imageio
            with imageio.get_writer(path, fps=fps) as w:
                for f in frames:
                    w.append_data(f)
            return path
        except (ImportError, ValueError, RuntimeError, OSError):
            pass                 # no writer backend for this format
    base = os.path.splitext(path)[0]
    np.savez_compressed(base + ".npz", frames=frames, fps=fps)
    try:
        from PIL import Image
    except ImportError:
        return base + ".npz"
    Image.fromarray(frames[0]).save(base + "_first.png")
    Image.fromarray(frames[-1]).save(base + "_last.png")
    return base + ".npz"
