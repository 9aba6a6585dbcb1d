"""Host-side bit packing and the plain shift (the device kernels live in
``pilosa_tpu_torch.kernels``)."""

from pilosa_tpu_torch.ops.packing import pack_bits, pack_shard_row, unpack_bits
