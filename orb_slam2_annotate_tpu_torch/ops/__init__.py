"""Front-end and matching ops: pyramid, FAST, selection, ORB, Hamming, matching."""
