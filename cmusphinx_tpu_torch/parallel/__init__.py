"""Multi-process runs over torch.distributed (port of
`cmusphinx_tpu/parallel/`) and the port's multi-process dry run."""

from .hosts import (HostInfo, init_distributed, local_partition,  # noqa: F401
                    partition_ctl)
