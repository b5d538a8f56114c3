"""Small shared helpers: the label tables (``labels``), the predict path's
background-thread prefetch of host batches (``prefetch``), timing and
profiling on the card (``profiling``), and the build cache's note
(``cache``)."""
