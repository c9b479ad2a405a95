"""One module per kind of traffic; a mix names its driver."""
