"""Device side of the port: state, tables, batched step, obs, vector env."""
