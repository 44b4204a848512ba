"""Host-side utilities: content digests and the dihedral tables, and the
port's copies of the JAX package's crash-safety and run-logging helpers
(atomic writes, bounded retry, fault injection, metrics, git provenance)."""
