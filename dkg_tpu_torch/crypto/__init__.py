"""Hashes and ciphers, ElGamal and the hybrid share encryption, Pedersen commitments, DLEQ proofs."""
