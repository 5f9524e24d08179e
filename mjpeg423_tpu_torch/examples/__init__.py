"""Runnable examples of the port, the counterparts of the repository's
examples/*.py.  Each is a module with main(argv) and a --device option
(default cuda; --device cpu runs the plain PyTorch path):

    python -m mjpeg423_tpu_torch.examples.roundtrip --device cpu
"""
