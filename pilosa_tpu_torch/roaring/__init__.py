"""Host-side roaring bitmaps: the durable storage format of fragments.

Device bitmaps are dense bit-packed tensors; roaring lives only on the
host, as the on-disk fragment format (snapshot + append-only op log).
"""

from pilosa_tpu_torch.roaring.bitmap import ARRAY, BITMAP, RUN, RoaringBitmap
from pilosa_tpu_torch.roaring.format import (
    OP_ADD,
    OP_REMOVE,
    deserialize,
    encode_op,
    replay_ops,
    serialize,
)
