"""Host IO: the on-disk formats and emitters the slice writes."""
