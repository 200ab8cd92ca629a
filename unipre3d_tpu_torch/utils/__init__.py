"""utils of the PyTorch port (see unipre3d_tpu_torch/__init__.py)."""
