"""PWC-Net optical flow."""
