"""staged_upload_bytes_per_image (bytes/image, program_counter): the bytes of
the pixel batches ``ClipImpl`` uploads through its page-locked staging buffer
(the program's ``impls.clip_staged_upload_bytes`` counter), over the images
of the traced slice. It reads ``upload_bytes_per_image`` where every slice
was staged. None where the program keeps no such counter, as on a CPU
device."""


def read(r):
    try:
        from panoptikon_tpu_torch import tracing
    except ImportError:
        return None
    staged = tracing.counters().get("impls.clip_staged_upload_bytes")
    images = r.work.get("images")
    return staged / images if staged is not None and images else None
