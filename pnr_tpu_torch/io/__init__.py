"""Host I/O: volumes (TIFF / v3draw / npy) and SWC morphologies."""

from pnr_tpu_torch.io.swc import read_swc, save_nodelist, swc_to_nodelist
from pnr_tpu_torch.io.volume import load_volume, load_volume_mmap, save_volume

__all__ = ["load_volume", "load_volume_mmap", "save_volume", "save_nodelist", "read_swc", "swc_to_nodelist"]
