"""Key/value data model: keys, ranges, mutations."""

from .keys import KeyRange, empty_range, key_after, strinc  # noqa: F401
