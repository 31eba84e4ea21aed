"""Small HDF5 helpers (counterpart of ``gwkit/utils/hdf5.py``). ``h5py`` is
imported inside the functions that need it; ``check_file_existence`` is the
CLIs' own, re-exported."""
from __future__ import annotations

import numpy as np

from gwkit_torch.cli.common import check_file_existence

__all__ = ["check_file_existence", "write_datasets", "read_datasets"]


def write_datasets(path: str, datasets: dict, mode: str = "w", attrs: dict | None = None) -> None:
    import h5py

    with h5py.File(path, mode) as fp:
        for key, val in datasets.items():
            fp.create_dataset(key, data=np.asarray(val))
        if attrs:
            for key, val in attrs.items():
                fp.attrs[key] = val


def read_datasets(path: str, keys=None) -> dict:
    import h5py

    out = {}
    with h5py.File(path, "r") as fp:
        for key in (keys if keys is not None else fp.keys()):
            out[key] = fp[key][()]
    return out
