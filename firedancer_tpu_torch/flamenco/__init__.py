"""flamenco: the Solana runtime layer (ref: src/flamenco/).  The port
holds the leader schedule and the blockstore the shred lane needs."""
