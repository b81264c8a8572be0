"""Example models of the port, each the counterpart of a script under the
repository's ``examples/`` directory, importable without side effects."""
