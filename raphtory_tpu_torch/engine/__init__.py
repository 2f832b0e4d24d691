"""Device engines: global graph tables and the hop-batched columnar engine."""
