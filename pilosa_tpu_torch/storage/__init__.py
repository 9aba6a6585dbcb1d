"""Storage tree: holder → index → field → view → fragment.

The reference's hierarchy and on-disk layout (``pilosa_tpu.storage``):
a fragment's durable truth is a host roaring file + op log, its
queryable form dense int32 leaves resident on the device.
"""

from pilosa_tpu_torch.storage.field import Field, FieldOptions
from pilosa_tpu_torch.storage.fragment import Fragment
from pilosa_tpu_torch.storage.holder import Holder
from pilosa_tpu_torch.storage.index import Index
from pilosa_tpu_torch.storage.load import load_existence, load_from_dense
from pilosa_tpu_torch.storage.view import VIEW_STANDARD, View
