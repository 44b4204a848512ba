"""Host-side utilities: content digests and the dihedral tables."""
