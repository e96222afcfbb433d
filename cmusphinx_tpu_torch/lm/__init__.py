"""Language-model estimation on the host."""
