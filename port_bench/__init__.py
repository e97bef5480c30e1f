"""The benchmark of the PyTorch port (`catre_tpu_torch`): `run.py` runs one cell."""
