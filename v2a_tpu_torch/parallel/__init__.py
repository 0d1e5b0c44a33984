"""Host-side pipelining of the port: the train batches' prefetcher."""
