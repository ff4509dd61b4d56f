"""Model definitions: configs, parameters, layers, attention, the dense
transformer and the ``Model`` facade."""
