"""Block stores of the port: the compression wrapper over the port's
codecs (the other stores are the host package's, through ``_host``)."""
