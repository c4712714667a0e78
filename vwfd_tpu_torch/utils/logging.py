"""File and screen logger (port of vwfd_tpu/utils/logging.py; reference:
utils/util.py:76-96 ``setup_logger``): the same format and handlers."""

import logging
import os


def setup_logger(name="base", root=None, phase="train", level=logging.INFO,
                 screen=True, tofile=False):
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
                            datefmt="%y-%m-%d %H:%M:%S")
    logger.setLevel(level)
    if tofile and root:
        os.makedirs(root, exist_ok=True)
        fh = logging.FileHandler(os.path.join(root, f"{phase}.log"), mode="w")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if screen:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    return logger
