"""The processing config: normalization of its dict form, and a YAML
loader that imports yaml only when called."""
