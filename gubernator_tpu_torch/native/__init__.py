"""Native code of the port: the compiled serving edge (`edge/`, a copy of
the reference package's sources) and its build (`edge_build`)."""
