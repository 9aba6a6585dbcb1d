"""Protobuf wire format: the messages of ``internal.proto``.

``pb2()`` returns a namespace of the message classes (``QueryRequest``,
``QueryResponse``, ``ImportRequest``, ...), built at first use from the
serialized ``FileDescriptorProto`` of ``internal.proto`` below, so no
``protoc`` is needed. The classes live in a private descriptor pool: a
process that also holds another module registering ``internal.proto``
in the default pool (with other bytes) loads both. ``pb2()`` returns
None when the ``google.protobuf`` runtime is missing; the HTTP layer then
answers protobuf requests with 406 and goes on serving JSON.

The descriptor is ``internal.proto`` as ``protoc`` compiles it (without
JSON names); its package stays ``pilosa_tpu``, because the message names
are part of the wire. Regenerate it after editing the proto with
``protoc --descriptor_set_out`` and clear every field's ``json_name``.
"""

from __future__ import annotations

import threading
import types

FILE_DESCRIPTOR = (
    b'\n\x0einternal.proto\x12\npilo'
    b'sa_tpu"\x87\x01\n\x0cQueryReques'
    b't\x12\r\n\x05query\x18\x01 \x01(\t\x12\x0e\n\x06sh'
    b'ards\x18\x02 \x03(\x04\x12\x14\n\x0ccolumn_a'
    b'ttrs\x18\x03 \x01(\x08\x12\x0e\n\x06remote\x18\x04'
    b' \x01(\x08\x12\x19\n\x11exclude_row_at'
    b'trs\x18\x05 \x01(\x08\x12\x17\n\x0fexclude_c'
    b'olumns\x18\x06 \x01(\x08"s\n\x04Attr\x12\x0b'
    b'\n\x03key\x18\x01 \x01(\t\x12\x0c\n\x04type\x18\x02 '
    b'\x01(\r\x12\x14\n\x0cstring_value\x18\x03 '
    b'\x01(\t\x12\x11\n\tint_value\x18\x04 \x01(\x03'
    b'\x12\x12\n\nbool_value\x18\x05 \x01(\x08\x12\x13'
    b'\n\x0bfloat_value\x18\x06 \x01(\x01"E\n'
    b'\x03Row\x12\x0f\n\x07columns\x18\x01 \x03(\x04\x12'
    b'\x0c\n\x04keys\x18\x02 \x03(\t\x12\x1f\n\x05attrs'
    b'\x18\x03 \x03(\x0b2\x10.pilosa_tpu.At'
    b'tr".\n\x04Pair\x12\n\n\x02id\x18\x01 \x01(\x04'
    b'\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\r\n\x05count'
    b'\x18\x03 \x01(\x04"(\n\x08ValCount\x12\r\n\x05'
    b'value\x18\x01 \x01(\x03\x12\r\n\x05count\x18\x02'
    b' \x01(\x03":\n\x08FieldRow\x12\r\n\x05fi'
    b'eld\x18\x01 \x01(\t\x12\x0e\n\x06row_id\x18\x02 '
    b'\x01(\x04\x12\x0f\n\x07row_key\x18\x03 \x01(\t"^'
    b'\n\nGroupCount\x12#\n\x05group\x18'
    b'\x01 \x03(\x0b2\x14.pilosa_tpu.Fie'
    b'ldRow\x12\r\n\x05count\x18\x02 \x01(\x04\x12\x0b'
    b'\n\x03sum\x18\x03 \x01(\x12\x12\x0f\n\x07has_sum'
    b'\x18\x04 \x01(\x08"<\n\rColumnAttrSe'
    b't\x12\n\n\x02id\x18\x01 \x01(\x04\x12\x1f\n\x05attrs'
    b'\x18\x02 \x03(\x0b2\x10.pilosa_tpu.At'
    b'tr"\x9b\x02\n\x0bQueryResult\x12\x0c\n\x04'
    b'type\x18\x01 \x01(\r\x12\x1c\n\x03row\x18\x02 \x01('
    b'\x0b2\x0f.pilosa_tpu.Row\x12\x1f\n\x05'
    b'pairs\x18\x03 \x03(\x0b2\x10.pilosa_t'
    b'pu.Pair\x12\t\n\x01n\x18\x04 \x01(\x04\x12\x0f\n\x07'
    b"changed\x18\x05 \x01(\x08\x12'\n\tval_c"
    b'ount\x18\x06 \x01(\x0b2\x14.pilosa_tp'
    b'u.ValCount\x12&\n\x06groups\x18\x07'
    b' \x03(\x0b2\x16.pilosa_tpu.Grou'
    b'pCount\x12\x0f\n\x07row_ids\x18\x08 \x03('
    b'\x04\x12\x10\n\x08row_keys\x18\t \x03(\t\x12/\n'
    b'\x0ccolumn_attrs\x18\n \x03(\x0b2\x19.'
    b'pilosa_tpu.ColumnAttrS'
    b'et"\x9f\x01\n\rQueryResponse\x12\x0b'
    b'\n\x03err\x18\x01 \x01(\t\x12(\n\x07results'
    b'\x18\x02 \x03(\x0b2\x17.pilosa_tpu.Qu'
    b'eryResult\x123\n\x10column_at'
    b'tr_sets\x18\x03 \x03(\x0b2\x19.pilosa'
    b'_tpu.ColumnAttrSet\x12\x0e\n\x06'
    b'status\x18\x04 \x01(\r\x12\x12\n\ntrace_'
    b'json\x18\x05 \x01(\t"M\n\x0eBatchQue'
    b'ryUnit\x12\r\n\x05index\x18\x01 \x01(\t\x12'
    b'\r\n\x05query\x18\x02 \x01(\t\x12\x0e\n\x06shar'
    b'ds\x18\x03 \x03(\x04\x12\r\n\x05trace\x18\x04 \x01('
    b'\t"@\n\x11BatchQueryRequest'
    b'\x12+\n\x07queries\x18\x01 \x03(\x0b2\x1a.pi'
    b'losa_tpu.BatchQueryUni'
    b't"B\n\x12BatchQueryRespons'
    b'e\x12,\n\tresponses\x18\x01 \x03(\x0b2\x19'
    b'.pilosa_tpu.QueryRespo'
    b'nse"0\n\rBlockChecksum\x12\r'
    b'\n\x05block\x18\x01 \x01(\x04\x12\x10\n\x08check'
    b'sum\x18\x02 \x01(\t"i\n\x10FragmentM'
    b'anifest\x12\r\n\x05field\x18\x01 \x01(\t'
    b'\x12\x0c\n\x04view\x18\x02 \x01(\t\x12\r\n\x05shar'
    b'd\x18\x03 \x01(\x04\x12)\n\x06blocks\x18\x04 \x03('
    b'\x0b2\x19.pilosa_tpu.BlockCh'
    b'ecksum"?\n\x0cSyncManifest'
    b'\x12/\n\tfragments\x18\x01 \x03(\x0b2\x1c.'
    b'pilosa_tpu.FragmentMan'
    b'ifest"O\n\x11FragmentBlock'
    b'List\x12\r\n\x05field\x18\x01 \x01(\t\x12\x0c\n'
    b'\x04view\x18\x02 \x01(\t\x12\r\n\x05shard\x18\x03'
    b' \x01(\x04\x12\x0e\n\x06blocks\x18\x04 \x03(\x04"T'
    b'\n\x11SyncBlocksRequest\x12\r\n'
    b'\x05index\x18\x01 \x01(\t\x120\n\tfragme'
    b'nts\x18\x02 \x03(\x0b2\x1d.pilosa_tpu'
    b'.FragmentBlockList"u\n\r'
    b'ImportRequest\x12\r\n\x05index'
    b'\x18\x01 \x01(\t\x12\r\n\x05field\x18\x02 \x01(\t\x12'
    b'\x0f\n\x07row_ids\x18\x03 \x03(\x04\x12\x12\n\nco'
    b'lumn_ids\x18\x04 \x03(\x04\x12\x12\n\ntime'
    b'stamps\x18\x05 \x03(\t\x12\r\n\x05clear\x18'
    b'\x06 \x01(\x08"e\n\x12ImportValueRe'
    b'quest\x12\r\n\x05index\x18\x01 \x01(\t\x12\r'
    b'\n\x05field\x18\x02 \x01(\t\x12\x12\n\ncolum'
    b'n_ids\x18\x03 \x03(\x04\x12\x0e\n\x06values\x18'
    b'\x04 \x03(\x03\x12\r\n\x05clear\x18\x05 \x01(\x08b\x06'
    b'proto3'
)

_lock = threading.Lock()
_pb2 = None
_tried = False


def _build():
    from google.protobuf import descriptor_pool, message_factory

    pool = descriptor_pool.DescriptorPool()
    fd = pool.AddSerializedFile(FILE_DESCRIPTOR)
    ns = types.SimpleNamespace(DESCRIPTOR=fd, POOL=pool)
    for name in fd.message_types_by_name:
        setattr(ns, name, message_factory.GetMessageClass(
            fd.message_types_by_name[name]))
    return ns


def pb2():
    global _pb2, _tried
    if _pb2 is not None or _tried:
        return _pb2
    with _lock:
        if not _tried:
            try:
                _pb2 = _build()
            except ImportError:
                _pb2 = None
            _tried = True
    return _pb2


def available() -> bool:
    return pb2() is not None
