"""The software codec on the host: the framings' member walks and the
LZ4 frame codec (counterpart of ``qatzip_tpu/sw/``)."""
