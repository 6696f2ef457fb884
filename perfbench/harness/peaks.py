"""The chip's published dense peaks (NVIDIA H100 SXM data sheet, 700 W),
by the device name ``torch.cuda.get_device_name`` gives; a name not in the
table has no peaks, and the readers that need one report nothing."""

PEAKS = {
    "H100 80GB HBM3": {"bf16_flop_s": 989e12, "tf32_flop_s": 495e12, "f32_flop_s": 67e12,
             "hbm_bytes_s": 3.35e12},
}


def peaks_for(kind: str):
    for key, table in PEAKS.items():
        if key in kind:
            return table
    return None
