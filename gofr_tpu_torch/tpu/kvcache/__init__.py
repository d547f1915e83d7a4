"""The prefix KV cache's host side (counterpart of gofr_tpu/tpu/kvcache/,
reduced to the block-chain hashes the resume token uses; the cache tiers
are still to be ported)."""

from .radix import CHAIN_SALT, chain_hashes, first_block_hash

__all__ = ["CHAIN_SALT", "chain_hashes", "first_block_hash"]
