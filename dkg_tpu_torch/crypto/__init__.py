"""BLAKE2s Merkle rows of the transcript, and the Pedersen commitment key."""
