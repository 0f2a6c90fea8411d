"""Drivers of the program's entry points, one module an entry, named by the
"entry" of a traffic file (gpubench/traffic/<traffic>.json)."""
