"""upload_bytes_per_image (bytes/image, program_counter): the bytes of the
pixel batches ``ClipImpl`` copies to its device (the program's
``impls.clip_upload_bytes`` counter), over the images of the traced slice.
None where the program keeps no such counter."""


def read(r):
    try:
        from panoptikon_tpu_torch import tracing
    except ImportError:
        return None
    sent = tracing.counters().get("impls.clip_upload_bytes")
    images = r.work.get("images")
    return sent / images if sent is not None and images else None
