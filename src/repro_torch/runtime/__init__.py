"""Host-side runtime of the port: the blob store and its msgpack codec,
checkpoints both packages read, and the opt-in finite guard."""
