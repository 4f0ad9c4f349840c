"""Published peaks by device name (``torch.cuda.get_device_name()``).

NVIDIA H100 SXM data sheet, dense rates: 3.35 TB/s of HBM3, 67 TFLOP/s in
float32 outside the tensor cores, at the full 700 W power limit. The
configurations state float32 with TF32 off, so float32 is the peak.
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
}


def peak_of(kind: str):
    """The peaks of device ``kind``, or None for a device not in the table."""
    return PEAKS.get(kind)
