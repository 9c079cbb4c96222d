"""store_bytes_per_row: bytes the published store's levels hold (every
family, slabs at their allocated size) over the rows it stores: the
preloaded, compacted plane of a serving cell; an ingest cell's last whole
epoch, published."""


def read(run):
    return run.store_bytes_per_row
