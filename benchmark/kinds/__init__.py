"""One module a kind of traffic (the traffic file's `kind`): `setup`,
the measured `window`, and the `check` against the plain reference."""
