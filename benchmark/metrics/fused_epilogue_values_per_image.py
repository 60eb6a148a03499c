"""fused_epilogue_values_per_image (values/image, program_counter): the int8
GEMM output values that the static-int8 block's fused epilogues consume (the
program's ``clip.int8_epilogue_values`` counter), over the images of the
traced slice: tokens × (3 + 1 + 4 + 1) × width × layers an image when every
epilogue of every block is fused. None where the program keeps no such
counter."""


def read(r):
    try:
        from panoptikon_tpu_torch import tracing
    except ImportError:
        return None
    values = tracing.counters().get("clip.int8_epilogue_values")
    images = r.work.get("images")
    return values / images if values is not None and images else None
