"""Host I/O of the port: the in-memory filter store, the pread reader,
the raw-event index and reader, read-ahead threads and feature tables.
File formats (HDF5, YAML, DataFrames) are read and written by adapter
functions that import h5py or pandas when they are called."""
