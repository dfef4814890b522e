"""The felt packing of L1 values (``felts.py``): a copy of the port's
``crypto/felts.py``, which the traffic generator packs deposit keys with."""
