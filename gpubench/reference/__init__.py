"""Plain references of the configurations, one module a family, named by a
configuration's "reference" key."""
