"""What the port's CLIs share.

Only ``set_process_title`` of ``pygcn_tpu/apps/common.py`` so far: the rest
of that module serves the simulator and the evaluator apps, which are not
ported yet.
"""

from __future__ import annotations


def set_process_title(app_name: str) -> None:
    """Name the process for ops visibility, as the reference's scripts do
    (``pygcn/train.py:4-5``); a no-op when ``setproctitle`` is missing."""
    try:
        import setproctitle

        setproctitle.setproctitle(f"pygcn-tpu-torch@{app_name}")
    except ImportError:
        pass
