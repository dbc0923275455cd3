"""Append-only message-file logging (the reference's ``use_file`` protocol,
train_funcs.py:83-97 and main_bradeepv3.py:145-150).  A copy of
``ee_semantic_segmentation_tpu/utils/logging.py``, except that in a
data-parallel run only rank 0 logs."""

from __future__ import annotations

import datetime as _dt

from ee_semantic_segmentation_tpu_torch.parallel.mesh import is_primary


def log_msg(msg: str, use_file: str | None = None, verbose: bool = True) -> None:
    if (not verbose and use_file is None) or not is_primary():
        return
    if use_file:
        with open(use_file, "a") as fh:
            fh.write(msg + "\n")
    else:
        print(msg)


def timestamp(fmt: str = "%m/%d %H:%M:%S") -> str:
    return _dt.datetime.now().strftime(fmt)
