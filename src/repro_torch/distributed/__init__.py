"""Device-level multi-tenancy (Algorithm 1 over device columns)."""
