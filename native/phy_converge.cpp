// Native convergence layer: packet validators + PHY<->network (de)framing.
//
// Framework note: the compute path of gr_dtl_jax is JAX/XLA;
// this host-side packet plumbing mirrors the reference's C++ testbed
// components (lib/testbed/packet_validator.cc, from_phy_impl.cc,
// to_phy_impl.cc) as a small C shared library consumed via ctypes —
// byte-level semantics match the reference:
//
//  - ip_validator:      IPv4 header-checksum verify + total length
//                       (packet_validator.cc:45-66)
//  - ethernet_validator: dst-MAC match, length = 14 + u16 at offset 16
//                       (packet_validator.cc:75-87)
//  - modified_ethernet: dst-MAC match, length = u16 at offset 12
//                       (packet_validator.cc:97-108)
//  - from_phy:          scan a decoded byte stream for valid packets,
//                       reassemble partially delivered ("jumbo")
//                       packets, strip the MODIFIED_ETHER 2-byte length
//                       (from_phy_impl.cc:78-180)
//  - to_phy:            prepend the MODIFIED_ETHER length after the
//                       12-byte MAC header (to_phy_impl.cc:86-146)
//
// Build: make -C native   (produces libdtl_testbed.so)

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>

extern "C" {

enum dtl_protocol {
    DTL_IPV4_ONLY = 0,
    DTL_ETHER_IPV4 = 1,
    DTL_MODIFIED_ETHER = 2,
};

// --- validators -----------------------------------------------------------

// Parse "aa:bb:cc:dd:ee:ff" -> 6 bytes; returns 0 on success.
int dtl_parse_mac(const char* s, uint8_t out[6]) {
    unsigned v[6];
    if (sscanf(s, "%x:%x:%x:%x:%x:%x", &v[0], &v[1], &v[2], &v[3], &v[4], &v[5]) != 6)
        return -1;
    for (int i = 0; i < 6; ++i) {
        if (v[i] > 0xff) return -1;
        out[i] = (uint8_t)v[i];
    }
    return 0;
}

static uint16_t rd_be16(const uint8_t* p) {
    return (uint16_t)((p[0] << 8) | p[1]);
}

// IPv4 header checksum verification; *packet_len = total length field.
// Returns 1 when the checksum matches (and is nonzero), else 0.
int dtl_ip_valid(const uint8_t* buf, size_t len, size_t* packet_len) {
    if (len < 20) { *packet_len = len; return 0; }
    size_t header_words = (buf[0] & 0x0f) * 2;  // ip_hl * 4 bytes / 2
    if (header_words * 2 > len) { *packet_len = len; return 0; }
    uint16_t stored = rd_be16(buf + 10);
    uint32_t sum = 0xffff;
    for (size_t i = 0; i < header_words; ++i) {
        uint16_t w = (i == 5) ? 0 : rd_be16(buf + 2 * i);  // checksum field as 0
        sum += w;
        if (sum > 0xffff) sum -= 0xffff;
    }
    *packet_len = rd_be16(buf + 2);
    return (uint16_t)(~sum) == stored && stored != 0;
}

int dtl_ether_valid(const uint8_t* buf, size_t len, const uint8_t mac[6],
                    size_t* packet_len) {
    // needs 18 bytes: the length field lives at offset 16..17
    if (len < 18) { *packet_len = len; return 0; }
    *packet_len = 14 + rd_be16(buf + 16);
    return memcmp(buf, mac, 6) == 0;
}

int dtl_modified_ether_valid(const uint8_t* buf, size_t len, const uint8_t mac[6],
                             size_t* packet_len) {
    if (len < 14) { *packet_len = len; return 0; }
    *packet_len = rd_be16(buf + 12);
    return memcmp(buf, mac, 6) == 0;
}

static int validate(int proto, const uint8_t* buf, size_t len, const uint8_t* mac,
                    size_t* packet_len) {
    switch (proto) {
        case DTL_IPV4_ONLY: return dtl_ip_valid(buf, len, packet_len);
        case DTL_ETHER_IPV4: return dtl_ether_valid(buf, len, mac, packet_len);
        case DTL_MODIFIED_ETHER:
            return dtl_modified_ether_valid(buf, len, mac, packet_len);
    }
    *packet_len = len;
    return 0;
}

// --- from_phy (PHY -> network deframer) ----------------------------------

struct dtl_from_phy {
    int proto;
    uint8_t mac[6];
    // partial-packet ("jumbo") reassembly buffer: the reference keeps
    // partial bytes in its output buffer across work calls
    // (from_phy_impl.cc d_offset_out/d_tail_packet_len); here they are
    // buffered in the handle and emitted only when complete.
    uint8_t pending[65536];
    size_t pending_len;
    size_t expected_len;  // expected (post-strip) length of the pending packet
    // short input tail (< 14 bytes, could be a packet-header start) held
    // for the next call — improves on the reference, which passes such
    // tails to the upper layer as garbage (from_phy_impl.cc:151-163)
    uint8_t head[16];
    size_t head_len;
};

dtl_from_phy* dtl_from_phy_new(int proto, const char* mac_str) {
    dtl_from_phy* h = (dtl_from_phy*)calloc(1, sizeof(dtl_from_phy));
    h->proto = proto;
    if (mac_str && dtl_parse_mac(mac_str, h->mac) != 0) {
        free(h);
        return nullptr;
    }
    return h;
}

void dtl_from_phy_free(dtl_from_phy* h) { free(h); }

// MODIFIED_ETHER strips the 2-byte length field (from_phy_impl.cc:47-57)
static size_t copy_pdu(int proto, uint8_t* out, const uint8_t* buf, size_t len) {
    if (proto == DTL_MODIFIED_ETHER) {
        memcpy(out, buf, 12);
        memcpy(out + 12, buf + 14, len - 12 - 2);
        return len - 2;
    }
    memcpy(out, buf, len);
    return len;
}

// Process a decoded byte buffer; emits reassembled packets into `out`
// and (offset, length) pairs into `tags` (up to max_tags).
// Returns bytes produced; *n_tags = boundary tags written.  Packets cut
// at the end of the input continue on the next call (jumbo state).
long dtl_from_phy_process(dtl_from_phy* h, const uint8_t* in_raw, size_t in_raw_len,
                          uint8_t* out, size_t out_cap,
                          long* tags, size_t max_tags, size_t* n_tags) {
    // stitch a held short tail from the previous call in front
    uint8_t* stitched = nullptr;
    const uint8_t* in = in_raw;
    size_t in_len = in_raw_len;
    if (h->head_len) {
        stitched = (uint8_t*)malloc(h->head_len + in_raw_len);
        memcpy(stitched, h->head, h->head_len);
        memcpy(stitched + h->head_len, in_raw, in_raw_len);
        in = stitched;
        in_len = h->head_len + in_raw_len;
        h->head_len = 0;
    }
    size_t offset_in = 0, offset_out = 0;
    *n_tags = 0;
    auto emit = [&](const uint8_t* buf, size_t len) {
        if (offset_out + len > out_cap) return false;
        memcpy(out + offset_out, buf, len);
        if (*n_tags < max_tags) {
            tags[2 * (*n_tags)] = (long)offset_out;
            tags[2 * (*n_tags) + 1] = (long)len;
            (*n_tags)++;
        }
        offset_out += len;
        return true;
    };
    while (offset_in < in_len) {
        size_t packet_len = 0;
        int valid = validate(h->proto, in + offset_in, in_len - offset_in, h->mac,
                             &packet_len);
        if (valid && packet_len >= 14) {
            if (h->pending_len) {
                // a new valid header interrupts an unfinished packet:
                // flush the partial for the upper layer (ref :99-106)
                if (!emit(h->pending, h->pending_len)) break;
                h->pending_len = 0;
            }
            size_t expected =
                (h->proto == DTL_MODIFIED_ETHER) ? packet_len - 2 : packet_len;
            if (offset_in + packet_len <= in_len) {
                // complete packet in the buffer: strip + emit directly
                uint8_t tmp[sizeof(h->pending)];
                if (expected > sizeof(tmp)) { offset_in = in_len; break; }
                size_t produced = copy_pdu(h->proto, tmp, in + offset_in, packet_len);
                if (!emit(tmp, produced)) break;
                offset_in += packet_len;
            } else {
                // jumbo start: buffer the (stripped) head, finish later
                size_t avail = in_len - offset_in;
                if (avail > sizeof(h->pending) || expected > sizeof(h->pending)) {
                    offset_in = in_len;
                    break;
                }
                h->pending_len = copy_pdu(h->proto, h->pending, in + offset_in, avail);
                h->expected_len = expected;
                offset_in = in_len;
            }
        } else {
            if (h->pending_len) {
                // jumbo continuation (ref :137-150)
                size_t to_consume = h->expected_len - h->pending_len;
                if (to_consume > in_len - offset_in) to_consume = in_len - offset_in;
                memcpy(h->pending + h->pending_len, in + offset_in, to_consume);
                offset_in += to_consume;
                h->pending_len += to_consume;
                if (h->pending_len == h->expected_len) {
                    if (!emit(h->pending, h->pending_len)) break;
                    h->pending_len = 0;
                    h->expected_len = 0;
                }
            } else {
                size_t remaining = in_len - offset_in;
                if (remaining < 14) {
                    // possibly a split packet header: hold for next call
                    memcpy(h->head, in + offset_in, remaining);
                    h->head_len = remaining;
                    offset_in = in_len;
                    break;
                }
                // garbage: resync by scanning for the next MAC match,
                // pass the skipped bytes through as one PDU (the
                // reference passes a blind-length chunk, ref :151-163,
                // which can swallow valid packets; scanning recovers)
                size_t to_consume = remaining;
                if (h->proto != DTL_IPV4_ONLY) {
                    for (size_t k = 1; k + 6 <= remaining; ++k) {
                        if (memcmp(in + offset_in + k, h->mac, 6) == 0) {
                            to_consume = k;
                            break;
                        }
                    }
                }
                if (!emit(in + offset_in, to_consume)) break;
                offset_in += to_consume;
            }
        }
    }
    if (stitched) free(stitched);
    return (long)offset_out;
}

// --- to_phy (network -> PHY framer) --------------------------------------

// Frame one PDU for the modem.  MODIFIED_ETHER inserts a 2-byte
// big-endian total length (pdu_len + 2) after the 12 MAC bytes
// (to_phy_impl.cc:115-131).  Returns bytes written or -1.
long dtl_to_phy_frame(int proto, const uint8_t* pdu, size_t pdu_len,
                      uint8_t* out, size_t out_cap) {
    if (proto == DTL_MODIFIED_ETHER) {
        if (pdu_len < 12 || out_cap < pdu_len + 2) return -1;
        size_t total = pdu_len + 2;
        memcpy(out, pdu, 12);
        out[12] = (uint8_t)((total >> 8) & 0xff);
        out[13] = (uint8_t)(total & 0xff);
        memcpy(out + 14, pdu + 12, pdu_len - 12);
        return (long)(pdu_len + 2);
    }
    if (out_cap < pdu_len) return -1;
    memcpy(out, pdu, pdu_len);
    return (long)pdu_len;
}

}  // extern "C"
