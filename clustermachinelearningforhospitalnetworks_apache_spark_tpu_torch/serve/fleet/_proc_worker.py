"""Spawn entry for the replica worker process (``python -m ..._proc_worker``).

A separate module from :mod:`.proc` so running it with ``-m`` does not
re-execute a module the package ``__init__`` already imported (runpy's
"found in sys.modules" double-import hazard)."""

from __future__ import annotations

import sys

from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve.fleet.proc import (  # noqa: E501
    _main,
)

if __name__ == "__main__":
    sys.exit(_main())
