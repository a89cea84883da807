"""Dataset home helpers (mirrors ``paddle_tpu/datasets/common.py``, all
of it; the reference's ``python/paddle/dataset/common.py`` DATA_HOME and
``download()``).  Nothing is fetched: ``download`` resolves a file
already in the data home (``PADDLE_TPU_DATA_HOME``, the reference's
variable and default) and raises otherwise, as the reference's."""

import hashlib
import os

__all__ = ["DATA_HOME", "data_path", "download", "md5file"]

DATA_HOME = os.environ.get(
    "PADDLE_TPU_DATA_HOME",
    os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu",
                 "dataset"))


def data_path(module_name, filename):
    return os.path.join(DATA_HOME, module_name, filename)


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """Local-only resolution: returns the file if it is in the data home,
    else raises with instructions."""
    filename = save_name or url.split("/")[-1]
    path = data_path(module_name, filename)
    if os.path.exists(path):
        if md5sum and md5file(path) != md5sum:
            raise IOError("%s exists but md5 mismatch" % path)
        return path
    raise IOError(
        "no download: place %s at %s to use the real dataset "
        "(synthetic surrogate is used by the reader creators otherwise)"
        % (filename, path))
