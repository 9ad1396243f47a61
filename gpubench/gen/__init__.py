"""The benchmark's own seeded input generators, one module a generator,
named by a configuration's ``generator`` key. Each module's
``generate(params, seed, device)`` returns the inputs on ``device``."""
