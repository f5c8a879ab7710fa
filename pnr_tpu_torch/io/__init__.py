"""Host I/O: volumes (TIFF / v3draw / npy) and SWC morphologies."""
