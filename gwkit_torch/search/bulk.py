"""Bulk file scorer with resume from its log (counterpart of
``gwkit/search/bulk.py``): each HDF5 file's [N, D, T] strain array is scored
in fixed-size chunks (the last one zero-padded to the chunk, so the model
sees one batch shape, and trimmed after), optionally through the fixed
[[1, -1], [-1, 1]] "USR" subtraction layer, and appended to a results
file; files already listed in the log are skipped on restart. ``h5py`` is
imported only where files are read and written.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Optional

import numpy as np
import torch

from gwkit_torch.device import resolve_device

USR_MATRIX = np.array([[1.0, -1.0], [-1.0, 1.0]], dtype=np.float32)


def usr_scores(probs_or_logits: np.ndarray) -> np.ndarray:
    """The subtraction layer: (N, 2) @ [[1, -1], [-1, 1]]; column 0 is the
    ranking statistic."""
    return np.asarray(probs_or_logits) @ USR_MATRIX


def score_files(task, files: List[str], output_path: str, log_path: Optional[str] = None,
                dataset_key: str = "data/0", chunk: int = 16, usr: bool = True, trainable=None) -> None:
    """Score every file's strain array on the task's device (``None``: the
    CUDA card; raises without one), one dataset per file in
    ``output_path``; skip the files already in the log. ``trainable``
    replaces the task's trainables for this call."""
    import h5py

    device = resolve_device(task.device)
    if trainable is not None:
        task = dataclasses.replace(task, trainable=trainable)
    log_path = log_path or output_path + ".log"
    done = set()
    if os.path.isfile(log_path):
        with open(log_path) as f:
            done = {line.strip() for line in f if line.strip()}

    with open(log_path, "a", buffering=1) as log:
        for path in files:
            name = os.path.basename(path)
            if name in done:
                logging.info("skipping %s (already scored)", name)
                continue
            with h5py.File(path, "r") as f:
                data = f[dataset_key][()]
            outs = []
            for s in range(0, len(data), chunk):
                batch = torch.from_numpy(np.asarray(data[s:s + chunk], np.float32)).to(device)
                n = len(batch)
                if n < chunk:  # pad to the chunk's shape
                    batch = torch.cat([batch, batch.new_zeros((chunk - n,) + batch.shape[1:])])
                outs.append(task.forward(batch)[:n])
            scores = torch.cat(outs).float().cpu().numpy() if outs else np.zeros((0, 2), np.float32)
            if usr and scores.ndim == 2 and scores.shape[1] == 2:
                scores = usr_scores(scores)
            with h5py.File(output_path, "a") as out_f:
                if name in out_f:
                    del out_f[name]
                out_f.create_dataset(name, data=scores)
            log.write(name + "\n")
            logging.info("scored %s: %s", name, scores.shape)
