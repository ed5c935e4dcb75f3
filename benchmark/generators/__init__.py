"""Map generators, one module a generator, found by the name a configuration gives."""
