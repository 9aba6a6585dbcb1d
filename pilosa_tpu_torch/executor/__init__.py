"""Query execution: structures, batched kernels, the executor, results."""

from pilosa_tpu_torch.executor.executor import Deferred, Executor, PQLError
from pilosa_tpu_torch.executor.result import RowResult, result_to_json
