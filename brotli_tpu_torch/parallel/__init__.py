"""Multi-shard compression: shards with window halos, a BroCatli merge."""
