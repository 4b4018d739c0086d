"""The entries a cell's traffic drives, one module each, found by the
traffic file's ``entry``: ``slots`` (``decode_slots``) and ``capture``
(``decode_ft8_message``)."""
