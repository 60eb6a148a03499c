"""embed_img_per_s (images/s, host_clock): every image embedded by
ClipImpl.predict and appended to the space in the window, over the window's
seconds (closed loop)."""


def read(r):
    return r.work["images"] / r.window_s if r.window_s > 0 and r.work.get("images") else None
