"""Small shared helpers: the label tables (``labels``) and the predict
path's background-thread prefetch of host batches (``prefetch``)."""
