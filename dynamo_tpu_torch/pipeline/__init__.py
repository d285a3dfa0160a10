"""Request pipeline pieces of the port: the Annotated stream envelope."""
