"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, 700 W)."""

HBM_BYTES_PER_S = 3.35e12  # HBM3, 80 GB


def roofline_pct(bytes_moved: float, device_s: float):
    """Share of the memory bound: the least time ``bytes_moved`` could take
    at the published HBM rate, over the device time it took (None when
    either is missing)."""
    if not bytes_moved or not device_s:
        return None
    return 100.0 * bytes_moved / HBM_BYTES_PER_S / device_s
