"""HPACK (RFC 7541) header compression for the native gRPC transport
(the port's own copy of gofr_tpu/grpcx/hpack.py: for the same header
sequence its encoder emits the same bytes).

Written from the spec: integer/string primitives (§5), indexed and literal
field representations (§6), the 61-entry static table (Appendix A) and the
Huffman code (Appendix B, data in ``_hufftable``). The reference framework
gets HTTP/2 for free from grpc-go; this framework carries
its own wire layer, so compression lives here.

Both peers of this implementation interoperate with any RFC-conformant
HPACK (dynamic-table size updates honored, Huffman both directions).
"""

from __future__ import annotations

from ._hufftable import HUFFMAN_CODES

STATIC_TABLE: tuple[tuple[bytes, bytes], ...] = (
    (b":authority", b""),
    (b":method", b"GET"),
    (b":method", b"POST"),
    (b":path", b"/"),
    (b":path", b"/index.html"),
    (b":scheme", b"http"),
    (b":scheme", b"https"),
    (b":status", b"200"),
    (b":status", b"204"),
    (b":status", b"206"),
    (b":status", b"304"),
    (b":status", b"400"),
    (b":status", b"404"),
    (b":status", b"500"),
    (b"accept-charset", b""),
    (b"accept-encoding", b"gzip, deflate"),
    (b"accept-language", b""),
    (b"accept-ranges", b""),
    (b"accept", b""),
    (b"access-control-allow-origin", b""),
    (b"age", b""),
    (b"allow", b""),
    (b"authorization", b""),
    (b"cache-control", b""),
    (b"content-disposition", b""),
    (b"content-encoding", b""),
    (b"content-language", b""),
    (b"content-length", b""),
    (b"content-location", b""),
    (b"content-range", b""),
    (b"content-type", b""),
    (b"cookie", b""),
    (b"date", b""),
    (b"etag", b""),
    (b"expect", b""),
    (b"expires", b""),
    (b"from", b""),
    (b"host", b""),
    (b"if-match", b""),
    (b"if-modified-since", b""),
    (b"if-none-match", b""),
    (b"if-range", b""),
    (b"if-unmodified-since", b""),
    (b"last-modified", b""),
    (b"link", b""),
    (b"location", b""),
    (b"max-forwards", b""),
    (b"proxy-authenticate", b""),
    (b"proxy-authorization", b""),
    (b"range", b""),
    (b"referer", b""),
    (b"refresh", b""),
    (b"retry-after", b""),
    (b"server", b""),
    (b"set-cookie", b""),
    (b"strict-transport-security", b""),
    (b"transfer-encoding", b""),
    (b"user-agent", b""),
    (b"vary", b""),
    (b"via", b""),
    (b"www-authenticate", b""),
)

_STATIC_FULL = {entry: i + 1 for i, entry in enumerate(STATIC_TABLE)}
_STATIC_NAME = {}
for _i, (_n, _v) in enumerate(STATIC_TABLE):
    _STATIC_NAME.setdefault(_n, _i + 1)

_ENTRY_OVERHEAD = 32  # RFC 7541 §4.1

# memo-cache size caps: header vocabularies are tiny in practice (method
# paths, status codes, content types); the caps only bound a pathological
# all-unique workload, where caching is pointless anyway
_STR_CACHE_MAX = 1024
_STR_CACHE_VALUE_MAX = 256
_FRAGMENT_CACHE_MAX = 2048


class HPACKError(Exception):
    pass


# -- integer / string primitives (§5) ----------------------------------------

def encode_int(value: int, prefix_bits: int, flags: int = 0) -> bytearray:
    limit = (1 << prefix_bits) - 1
    out = bytearray()
    if value < limit:
        out.append(flags | value)
        return out
    out.append(flags | limit)
    value -= limit
    while value >= 0x80:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    out.append(value)
    return out


def decode_int(data: bytes, pos: int, prefix_bits: int) -> tuple[int, int]:
    limit = (1 << prefix_bits) - 1
    if pos >= len(data):
        raise HPACKError("truncated integer")
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HPACKError("truncated integer continuation")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if shift > 62:
            raise HPACKError("integer overflow")
        if not b & 0x80:
            return value, pos


# -- Huffman (Appendix B) -----------------------------------------------------

_DECODE = {(bits, code): sym for sym, (code, bits) in enumerate(HUFFMAN_CODES)}
_EOS_PREFIXES = set()
_eos_code, _eos_bits = HUFFMAN_CODES[256]
for _n in range(1, 8):
    _EOS_PREFIXES.add((_n, _eos_code >> (_eos_bits - _n)))


def huffman_encode(data: bytes) -> bytes:
    acc = 0
    nbits = 0
    out = bytearray()
    for sym in data:
        code, bits = HUFFMAN_CODES[sym]
        acc = (acc << bits) | code
        nbits += bits
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
    if nbits:
        pad = 8 - nbits
        out.append(((acc << pad) | ((1 << pad) - 1)) & 0xFF)
    return bytes(out)


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    code = 0
    nbits = 0
    for byte in data:
        for shift in range(7, -1, -1):
            code = (code << 1) | ((byte >> shift) & 1)
            nbits += 1
            sym = _DECODE.get((nbits, code))
            if sym is not None:
                if sym == 256:
                    raise HPACKError("EOS symbol in huffman stream")
                out.append(sym)
                code = 0
                nbits = 0
            elif nbits > 30:
                raise HPACKError("invalid huffman code")
    if nbits >= 8 or (nbits and (nbits, code) not in _EOS_PREFIXES):
        raise HPACKError("invalid huffman padding")
    return bytes(out)


def encode_string(data: bytes, huffman: bool = True) -> bytearray:
    if huffman:
        encoded = huffman_encode(data)
        if len(encoded) < len(data):
            out = encode_int(len(encoded), 7, 0x80)
            out.extend(encoded)
            return out
    out = encode_int(len(data), 7, 0x00)
    out.extend(data)
    return out


def decode_string(data: bytes, pos: int) -> tuple[bytes, int]:
    if pos >= len(data):
        raise HPACKError("truncated string")
    is_huffman = bool(data[pos] & 0x80)
    length, pos = decode_int(data, pos, 7)
    if pos + length > len(data):
        raise HPACKError("string exceeds block")
    raw = bytes(data[pos : pos + length])
    return (huffman_decode(raw) if is_huffman else raw), pos + length


# -- dynamic table ------------------------------------------------------------

class _DynamicTable:
    """Eviction-ordered dynamic table with an O(1) reverse index.

    ``entries[i]`` holds the entry inserted ``i`` insertions ago (newest
    first, per §2.3.2). The reverse index maps (name, value) and name to
    the newest matching insertion's ABSOLUTE id (a monotonically growing
    counter), so ``find`` never re-walks the list: the entry's current
    position is ``_base - abs_id`` regardless of how many inserts and
    evictions happened since. Mappings are dropped at eviction only when
    they still point at the evicted insertion (a newer duplicate wins)."""

    def __init__(self, max_size: int = 4096):
        self.entries: list[tuple[bytes, bytes]] = []
        self.size = 0
        self.max_size = max_size
        self.cap = max_size  # protocol ceiling (SETTINGS_HEADER_TABLE_SIZE)
        self._base = 0                # total insertions ever
        self._pair_abs: dict[tuple[bytes, bytes], int] = {}
        self._name_abs: dict[bytes, int] = {}

    def _pop_last(self) -> None:
        abs_id = self._base - (len(self.entries) - 1)
        en, ev = self.entries.pop()
        self.size -= len(en) + len(ev) + _ENTRY_OVERHEAD
        if self._pair_abs.get((en, ev)) == abs_id:
            del self._pair_abs[(en, ev)]
        if self._name_abs.get(en) == abs_id:
            del self._name_abs[en]

    def add(self, name: bytes, value: bytes) -> None:
        need = len(name) + len(value) + _ENTRY_OVERHEAD
        while self.entries and self.size + need > self.max_size:
            self._pop_last()
        if need <= self.max_size:
            self._base += 1
            self.entries.insert(0, (name, value))
            self.size += need
            self._pair_abs[(name, value)] = self._base
            self._name_abs[name] = self._base

    def resize(self, new_max: int) -> None:
        if new_max > self.cap:
            raise HPACKError(f"table size {new_max} above ceiling {self.cap}")
        self.max_size = new_max
        while self.entries and self.size > self.max_size:
            self._pop_last()

    def get(self, index: int) -> tuple[bytes, bytes]:
        # index is 1-based over static + dynamic (§2.3.3)
        if 1 <= index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        d = index - len(STATIC_TABLE) - 1
        if 0 <= d < len(self.entries):
            return self.entries[d]
        raise HPACKError(f"invalid index {index}")

    def find(self, name: bytes, value: bytes) -> tuple[int, bool]:
        """-> (index, exact). index 0 = not found. Preference order
        (static exact, dynamic exact, static name, dynamic name) and
        newest-duplicate-wins match the linear scan this replaced, so
        encoded blocks are byte-identical."""
        exact = _STATIC_FULL.get((name, value))
        if exact:
            return exact, True
        abs_id = self._pair_abs.get((name, value))
        if abs_id is not None:
            return len(STATIC_TABLE) + 1 + (self._base - abs_id), True
        name_idx = _STATIC_NAME.get(name)
        if name_idx:
            return name_idx, False
        abs_id = self._name_abs.get(name)
        if abs_id is not None:
            return len(STATIC_TABLE) + 1 + (self._base - abs_id), False
        return 0, False


# -- encoder / decoder --------------------------------------------------------

def _norm(h: "str | bytes") -> bytes:
    return h.encode("ascii") if isinstance(h, str) else h


_NAME_NORM: dict = {}


def _norm_name(h: "str | bytes") -> bytes:
    """``_norm(h).lower()`` with a small memo — header NAMES draw from a
    tiny vocabulary and the per-call encode+lower allocations showed up
    in the transport profile."""
    v = _NAME_NORM.get(h)
    if v is None:
        v = _norm(h).lower()
        if len(_NAME_NORM) < _STR_CACHE_MAX:
            _NAME_NORM[h] = v
    return v


# (name, value) -> precomputed §6.1 indexed bytes for every static-exact
# entry. Static indices never move, so these are valid under ANY dynamic
# table state — the unconditionally-safe half of the encode cache.
_STATIC_EXACT_BYTES = {entry: bytes(encode_int(i + 1, 7, 0x80))
                       for i, entry in enumerate(STATIC_TABLE)}

# (name, value) -> stateless block fragment (see encode_stateless)
_STATELESS_FRAGMENTS: dict = {}


def encode_stateless(headers) -> bytes:
    """Encode a header block that neither reads nor writes ANY dynamic
    table state: static-exact fields as §6.1 indexed, everything else as
    §6.2.2 literal-without-indexing (static name index when one exists).

    Such a block is valid at any point in a connection's lifetime and
    leaves the peer's decoder table untouched, so it can be pre-encoded
    ONCE PER SERVER (response headers, trailer templates) and written
    from any thread without holding the connection's encoder lock — the
    HPACK half of the first-token fast path. Fragments memoize per
    (name, value): the dynamic-table-safe encode cache."""
    out = bytearray()
    for name, value in headers:
        name, value = _norm_name(name), _norm(value)
        key = (name, value)
        frag = _STATELESS_FRAGMENTS.get(key)
        if frag is None:
            frag = _STATIC_EXACT_BYTES.get(key)
            if frag is None:
                nidx = _STATIC_NAME.get(name, 0)
                buf = encode_int(nidx, 4, 0x00)
                if not nidx:
                    buf.extend(encode_string(name))
                buf.extend(encode_string(value))
                frag = bytes(buf)
            # memoize only short values: grpc-message trailers carry
            # per-request error text — high-cardinality, arbitrary
            # length — which would pin memory AND crowd out the hot
            # pairs; clear-on-full (not stop-on-full) keeps the cache
            # live for new legitimate pairs after churn
            if len(value) <= _STR_CACHE_VALUE_MAX:
                if len(_STATELESS_FRAGMENTS) >= _FRAGMENT_CACHE_MAX:
                    _STATELESS_FRAGMENTS.clear()
                _STATELESS_FRAGMENTS[key] = frag
        out += frag
    return bytes(out)


class Encoder:
    def __init__(self, max_table_size: int = 4096):
        self.table = _DynamicTable(max_table_size)
        self.huffman = True
        self.indexing = True
        self._str_cache: dict = {}
        self._pending_size_update: int | None = None
        self._pending_size_min: int | None = None

    def _estr(self, data: bytes) -> "bytes | bytearray":
        """encode_string with a memo: the Huffman bit-packing loop is the
        dominant per-header cost, and header strings repeat heavily
        (paths, content types, status codes). Pure-function cache, so
        cached and uncached output are byte-identical."""
        if len(data) > _STR_CACHE_VALUE_MAX:
            return encode_string(data, self.huffman)
        key = (data, self.huffman)
        out = self._str_cache.get(key)
        if out is None:
            if len(self._str_cache) >= _STR_CACHE_MAX:
                self._str_cache.clear()
            out = bytes(encode_string(data, self.huffman))
            self._str_cache[key] = out
        return out

    def set_max_table_size(self, size: int) -> None:
        """Apply the peer's SETTINGS_HEADER_TABLE_SIZE: shrink our encoding
        table to fit and schedule the §6.3 dynamic-table-size update that
        must open the next header block (RFC 7541 §4.2). Entries over the
        new size are evicted here, so find() can never emit an indexed
        reference the peer's shrunken table cannot resolve. Several changes
        between header blocks track the MINIMUM too — §4.2 requires the
        smallest intermediate size be signaled (so a shrink-then-grow still
        flushes the peer's table) before the final one."""
        size = min(size, self.table.cap)
        self.table.resize(size)
        self._pending_size_min = (size if self._pending_size_min is None
                                  else min(self._pending_size_min, size))
        self._pending_size_update = size

    def encode(self, headers) -> bytes:
        out = bytearray()
        if self._pending_size_update is not None:
            if self._pending_size_min < self._pending_size_update:
                out.extend(encode_int(self._pending_size_min, 5, 0x20))
            out.extend(encode_int(self._pending_size_update, 5, 0x20))
            self._pending_size_update = None
            self._pending_size_min = None
        for name, value in headers:
            name, value = _norm_name(name), _norm(value)
            idx, exact = self.table.find(name, value)
            if exact:
                if idx <= len(STATIC_TABLE):
                    out += _STATIC_EXACT_BYTES[(name, value)]
                else:
                    out.extend(encode_int(idx, 7, 0x80))  # §6.1 indexed
            elif not self.indexing:
                out.extend(encode_int(idx, 4, 0x00))  # §6.2.2 (idx may be 0)
                if not idx:
                    out.extend(self._estr(name))
                out.extend(self._estr(value))
            elif idx:
                # §6.2.1 literal with incremental indexing, indexed name
                out.extend(encode_int(idx, 6, 0x40))
                out.extend(self._estr(value))
                self.table.add(name, value)
            else:
                out.extend(encode_int(0, 6, 0x40))  # new name
                out.extend(self._estr(name))
                out.extend(self._estr(value))
                self.table.add(name, value)
        return bytes(out)


class Decoder:
    def __init__(self, max_table_size: int = 4096):
        self.table = _DynamicTable(max_table_size)

    def decode(self, data: bytes) -> list[tuple[bytes, bytes]]:
        headers: list[tuple[bytes, bytes]] = []
        pos = 0
        while pos < len(data):
            b = data[pos]
            if b & 0x80:  # §6.1 indexed
                idx, pos = decode_int(data, pos, 7)
                if idx == 0:
                    raise HPACKError("index 0 in indexed representation")
                headers.append(self.table.get(idx))
            elif b & 0x40:  # §6.2.1 literal, incremental indexing
                idx, pos = decode_int(data, pos, 6)
                name, value, pos = self._literal(data, pos, idx)
                self.table.add(name, value)
                headers.append((name, value))
            elif b & 0x20:  # §6.3 dynamic table size update
                size, pos = decode_int(data, pos, 5)
                self.table.resize(size)
            else:  # §6.2.2/§6.2.3 literal without indexing / never indexed
                idx, pos = decode_int(data, pos, 4)
                name, value, pos = self._literal(data, pos, idx)
                headers.append((name, value))
        return headers

    def _literal(self, data: bytes, pos: int, idx: int):
        if idx:
            name = self.table.get(idx)[0]
        else:
            name, pos = decode_string(data, pos)
        value, pos = decode_string(data, pos)
        return name, value, pos
