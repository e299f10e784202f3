"""Device meshes and the collectives between their members (port of
``repro.parallel``)."""
