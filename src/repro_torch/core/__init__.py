"""The LLCySA store, ported: host-side schema, keys, filter programs,
batching and planning (numpy copies of the reference's modules), the
host EventStore, and the device ingest plane and scan path in PyTorch."""
