"""System keyspace encodings (ref: fdbclient/SystemData.{h,cpp}).

Cluster metadata lives INSIDE the database under `\\xff`-prefixed keys and
is mutated by ordinary transactions; the proxy interprets committed
mutations on these keys (cluster/apply path, ref:
fdbserver/ApplyMetadataMutation.h) to update its caches. This module owns
the encodings so ManagementAPI, the proxy, and DD agree byte-for-byte.
"""

from __future__ import annotations

from ..kv.keys import KeyRange

SYSTEM_PREFIX = b"\xff"

# -- configuration (ref: configKeysPrefix \xff/conf/) --
CONF_PREFIX = SYSTEM_PREFIX + b"/conf/"

# -- exclusion (ref: excludedServersPrefix \xff/conf/excluded/) --
EXCLUDED_PREFIX = CONF_PREFIX + b"excluded/"

# -- server list (ref: serverListPrefix \xff/serverList/) --
SERVER_LIST_PREFIX = SYSTEM_PREFIX + b"/serverList/"

# -- move keys lock (ref: moveKeysLockOwnerKey) --
MOVE_KEYS_LOCK_OWNER = SYSTEM_PREFIX + b"/moveKeysLock/Owner"

# -- keyServers (ref: keyServersPrefix \xff/keyServers/) --
KEY_SERVERS_PREFIX = SYSTEM_PREFIX + b"/keyServers/"


def config_key(name: str) -> bytes:
    return CONF_PREFIX + name.encode()


def decode_config_key(key: bytes) -> str:
    assert key.startswith(CONF_PREFIX)
    return key[len(CONF_PREFIX):].decode()


def excluded_server_key(tag: int) -> bytes:
    return EXCLUDED_PREFIX + str(tag).encode()


def decode_excluded_server_key(key: bytes) -> int:
    assert key.startswith(EXCLUDED_PREFIX)
    return int(key[len(EXCLUDED_PREFIX):])


def excluded_servers_range() -> KeyRange:
    return KeyRange(EXCLUDED_PREFIX, EXCLUDED_PREFIX + b"\xff")


def server_list_key(tag: int) -> bytes:
    return SERVER_LIST_PREFIX + str(tag).encode()


def server_list_range() -> KeyRange:
    return KeyRange(SERVER_LIST_PREFIX, SERVER_LIST_PREFIX + b"\xff")


def is_system_key(key: bytes) -> bool:
    return key.startswith(SYSTEM_PREFIX)
